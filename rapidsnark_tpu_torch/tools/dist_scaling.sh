#!/bin/bash
# The sharded prove on several cards, one NCCL rank a card:
#
#     bash rapidsnark_tpu_torch/tools/dist_scaling.sh [outdir]
#
# from the root of a checkout, on a machine with four cards. Generates
# the 2^24 sqchain on the card, proves it with one fixed (r, s) on 1, 2,
# 4, 2 and 1 ranks (tools/dist_prove_worker, joined by the RSTPU_* knobs;
# each rank prints its phases and collective seconds), checks every
# rank's proof equals the first one-rank proof byte for byte, then
# proves through the CLI with RSTPU_SHARD=1 (a rank a visible card) and
# without knobs (one card); those proofs are pairing-verified. Walls
# include each process's start, zkey read and set-up. Output: outdir
# (default build/dist_scaling).
set -u
O=${1:-build/dist_scaling}
mkdir -p $O
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 -c "import sys, torch; print(sys.version, torch.__version__, torch.version.cuda, torch.cuda.device_count())"
python3 -c "import sys; sys.path.insert(0, '.'); from rapidsnark_tpu_torch import device as D; D.build(force=True)" || exit 1
python3 -m rapidsnark_tpu_torch.fixtures 24 > $O/fixtures.log 2>&1 || { tail $O/fixtures.log; exit 1; }
Z=bench_fixtures/sqchain16777216.zkey; W=bench_fixtures/sqchain16777216.wtns
R=1122334455; S=9988776655
verify() {
python3 - "$Z" "$1" "$2" <<'PY'
import json, sys
sys.path.insert(0, '.')
from rapidsnark_tpu_torch.io.zkey import read_zkey, zkey_to_ref
from rapidsnark_tpu_torch.ref.groth16 import Proof, verify
z, pp, pu = sys.argv[1:]
pj = json.load(open(pp)); pub = [int(v) for v in json.load(open(pu))]
pr = Proof(a=(int(pj["pi_a"][0]), int(pj["pi_a"][1])), b=((int(pj["pi_b"][0][0]), int(pj["pi_b"][0][1])), (int(pj["pi_b"][1][0]), int(pj["pi_b"][1][1]))), c=(int(pj["pi_c"][0]), int(pj["pi_c"][1])))
print("verify", pp, verify(zkey_to_ref(read_zkey(z), tables=False), pr, pub), flush=True)
PY
}
for D in 1 2 4 2 1; do
  d=$O/d$D; mkdir -p $d
  port=$((29500 + D)); t0=$(date +%s.%N)
  for i in $(seq 0 $((D - 1))); do
    RSTPU_COORD=127.0.0.1:$port RSTPU_NPROCS=$D RSTPU_PROC_ID=$i \
      python3 -m rapidsnark_tpu_torch.tools.dist_prove_worker $Z $W $d $R $S cuda \
      > $d/rank$i.json 2> $d/rank$i.err &
  done
  wait
  echo "D=$D wall $(python3 -c "import sys, time; print(round(time.time() - float(sys.argv[1]), 2))" $t0)"
  for i in $(seq 0 $((D - 1))); do
    tail -c 2000 $d/rank$i.err | grep -v "hostname of the client" | tail -3
    python3 -c "import json,sys; d=json.loads(open(sys.argv[1]).read().strip().splitlines()[-1]); print(json.dumps({k: v for k, v in d.items() if k not in ('proof', 'launches')}))" $d/rank$i.json
    cmp $O/d1/proof_0.json $d/proof_$i.json && echo "D=$D rank $i proof equals D=1's"
  done
done
verify $O/d4/proof_3.json $O/d4/public_3.json
t0=$(date +%s.%N)
RSTPU_SHARD=1 python3 -m rapidsnark_tpu_torch.cli $Z $W $O/shard_proof.json $O/shard_public.json; echo "RSTPU_SHARD=1 CLI rc $? wall $(python3 -c "import sys, time; print(round(time.time() - float(sys.argv[1]), 2))" $t0)"
verify $O/shard_proof.json $O/shard_public.json
t0=$(date +%s.%N)
python3 -m rapidsnark_tpu_torch.cli $Z $W $O/single_proof.json $O/single_public.json; echo "single-card CLI rc $? wall $(python3 -c "import sys, time; print(round(time.time() - float(sys.argv[1]), 2))" $t0)"
verify $O/single_proof.json $O/single_public.json
