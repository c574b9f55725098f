"""Proof service: the multi-circuit state machine (fullprover) behind the
reference's HTTP routes (http); `python -m rapidsnark_tpu_torch.server`
starts it on the card."""

from .fullprover import FullProver, Status  # noqa: F401
