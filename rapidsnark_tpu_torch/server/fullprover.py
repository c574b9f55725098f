"""Multi-circuit async prover state machine.

Counterpart of `rapidsnark_tpu/server/fullprover.py`; reproduces the
semantics of the reference's src/fullprover.cpp (SURVEY.md §3.3):

  * multi-circuit registry keyed by zkey basename (getfilename,
    fullprover.cpp:14-19),
  * one prove at a time on a detached worker thread (fullprover.cpp:96),
  * SINGLE-SLOT pending queue — a new request overwrites an unstarted
    pending one (fullprover.cpp:72-74),
  * abort is cooperative and coarse: the canceled flag is consulted once,
    before prove() starts (fullprover.cpp:154); a running prove is never
    interrupted; cancellation yields status=aborted with proof={},
  * witness generation by SUBPROCESS: `<build>/<circuit>
    <build>/input_<circuit>.json <build>/<circuit>.wtns`
    (fullprover.cpp:116-132, circom_runtime executable convention),
  * status payload shapes from FullProver::getStatus
    (fullprover.cpp:216-240): success carries proof and pubData as
    JSON-encoded *strings* (the reference calls .dump() on both).

One deliberate divergence: getStatus takes the lock (the reference reads
shared state unlocked — SURVEY.md §5.2 flags it as a race not to copy).
"""

from __future__ import annotations

import json
import os
import subprocess
import threading
from enum import IntEnum
from typing import Callable, Dict, Optional, Sequence

from .. import device as D
from ..prover import Prover
from ..ref.field import R_FR


class Status(IntEnum):
    """fullprover.hpp:14 enum, values preserved."""
    aborted = -2
    busy = -1
    failed = 0
    success = 1
    unverified = 2
    uninitialized = 3
    initializing = 5
    ready = 6


def circuit_name(path: str) -> str:
    """Basename without extension (getfilename, fullprover.cpp:14-19)."""
    base = os.path.basename(path)
    dot = base.rfind(".")
    return base[:dot] if dot != -1 else base


class FullProver:
    def __init__(self, zkey_files: Sequence[str], build_dir: str = "./build",
                 window_bits: Optional[int] = None, device=None,
                 witness_generator: Optional[Callable] = None,
                 defer_load: bool = False, mesh=None):
        """witness_generator(circuit, input_json_path, wtns_path) overrides
        the subprocess convention (tests / non-circom deployments).

        `device` (None: the CUDA card, which must be present) is handed
        to every circuit's Prover, and so is `mesh` (parallel/multihost.
        Mesh, as the JAX package's `mesh=`): each Prover is then this
        rank's part of a sharded prove, on the mesh's device. Every rank
        of the mesh must take the same requests in the same order (the
        port's server builds no mesh, as the JAX package's does not).

        defer_load=True leaves the zkey registry empty with
        status=initializing; call load() to populate it — the HTTP
        front-end uses this so /status answers while a multi-GB
        registry uploads (the reference signals init only via logs,
        fullprover.cpp:21-62, because pistache starts after the
        constructor; a live /status during init is strictly better)."""
        self._lock = threading.RLock()
        self._build_dir = build_dir
        self._witness_generator = witness_generator
        self._zkey_files = list(zkey_files)
        self._window_bits = window_bits
        self._device = D.resolve(device if mesh is None else mesh.device)
        self._mesh = mesh

        self.provers: Dict[str, Prover] = {}
        self._pending_input = ""
        self._pending_circuit = ""
        self._executing_input = ""
        self._executing_circuit = ""
        self._canceled = False
        self._err_string = ""
        self._proof = None
        self._pub_data = []
        self.status = Status.initializing
        if not defer_load:
            self.load()

    def load(self) -> None:
        """Populate the zkey registry, then flip initializing -> ready
        (fullprover.cpp:21-62 constructor body). Prove requests that
        arrived during init stay pending and start here."""
        from ..io.zkey import read_zkey

        for path in self._zkey_files:
            name = circuit_name(path)
            zkey = read_zkey(path)
            if zkey.r != R_FR:
                raise ValueError("zkey curve not supported")  # :35-37
            self.provers[name] = Prover(zkey, window_bits=self._window_bits,
                                        device=self._device, mesh=self._mesh)
            # the Prover repacked every table; release the file map now
            # (a long-lived service does not hold one map per circuit)
            zkey.close()
        with self._lock:
            self.status = Status.ready
            self._check_pending()

    # -- API (proverapi.cpp routes call these) -------------------------------

    def start_prove(self, input_json: str, circuit: str) -> None:
        """POST /input/:circuit (fullprover.cpp:69-79)."""
        with self._lock:
            self._pending_input = input_json
            self._pending_circuit = circuit
            if self.status == Status.busy:
                self.abort()
            self._check_pending()

    def abort(self) -> None:
        """POST /cancel (fullprover.cpp:204-213): only while busy."""
        with self._lock:
            if self.status != Status.busy:
                return
            self._canceled = True

    def get_status(self) -> dict:
        """GET /status payload (fullprover.cpp:216-240)."""
        with self._lock:
            st: dict = {}
            if self.status == Status.ready:
                st["status"] = "ready"
            elif self.status == Status.aborted:
                st["status"] = "aborted"
            elif self.status == Status.failed:
                st["status"] = "failed"
                st["error"] = self._err_string
            elif self.status == Status.success:
                st["status"] = "success"
                # reference dumps both to strings (fullprover.cpp:231-232)
                st["proof"] = json.dumps(self._proof)
                st["pubData"] = json.dumps(self._pub_data)
            elif self.status == Status.busy:
                st["status"] = "busy"
            # initializing/uninitialized/unverified fall through to {}
            # exactly like the reference (no branch, fullprover.cpp:
            # 216-240) — a poll during registry load gets 200 + {}
            return st

    # -- internals -------------------------------------------------------------

    def _check_pending(self) -> None:
        """fullprover.cpp:82-101; caller holds the lock. A request that
        arrives during init stays pending until load() completes."""
        if self.status not in (Status.busy, Status.initializing):
            if self._pending_input and self._pending_circuit:
                self.status = Status.busy
                self._executing_input = self._pending_input
                self._executing_circuit = self._pending_circuit
                self._pending_input = ""
                self._pending_circuit = ""
                self._err_string = ""
                self._canceled = False
                self._proof = None
                th = threading.Thread(target=self._thread_calculate_prove,
                                      daemon=True)
                th.start()

    def _is_canceled(self) -> bool:
        with self._lock:
            return self._canceled

    def _generate_witness(self, circuit: str, input_path: str,
                          wtns_path: str) -> None:
        if self._witness_generator is not None:
            self._witness_generator(circuit, input_path, wtns_path)
            return
        # circom_runtime executable convention (fullprover.cpp:116-132)
        cmd = [os.path.join(self._build_dir, circuit), input_path, wtns_path]
        subprocess.run(cmd, capture_output=True, check=False)

    def _thread_calculate_prove(self) -> None:
        """fullprover.cpp:103-172."""
        from ..io.wtns import read_wtns
        from ..utils.limbs import words_to_ints

        try:
            circuit = self._executing_circuit
            parsed = json.loads(self._executing_input)  # may raise -> failed
            os.makedirs(self._build_dir, exist_ok=True)
            input_path = os.path.join(self._build_dir,
                                      f"input_{circuit}.json")
            with open(input_path, "w") as f:
                json.dump(parsed, f)
            wtns_path = os.path.join(self._build_dir, f"{circuit}.wtns")

            self._generate_witness(circuit, input_path, wtns_path)

            wtns = read_wtns(wtns_path)
            if wtns.prime != R_FR:
                raise ValueError("different wtns curve")   # :141-143

            prover = self.provers[circuit]
            publics = words_to_ints(
                wtns.values[1:prover.n_public + 1])
            with self._lock:
                self._pub_data = [str(v) for v in publics]

            if not self._is_canceled():
                proof, _ = prover.prove(wtns.values)
                result = proof.to_json_dict()
            else:
                result = {}                                  # :156-158
            with self._lock:
                self._proof = result
            self._calc_finished()
        except Exception as e:
            # the lock covers this write too: get_status / _calc_finished
            # read _err_string concurrently (the reference's unlocked-read
            # race, SURVEY.md §5.2, is not copied on either side)
            if not self._is_canceled():
                with self._lock:
                    self._err_string = str(e)
            self._calc_finished()

    def _calc_finished(self) -> None:
        """fullprover.cpp:174-191."""
        with self._lock:
            if self._canceled:
                self.status = Status.aborted
            elif self._err_string:
                self.status = Status.failed
            else:
                self.status = Status.success
            self._canceled = False
            self._executing_input = ""
            self._check_pending()
