# The assessors experiment recorded in chain_probe/assessors.json, on one
# CUDA card, from the repository root: one G (the port's dcgan z 10, 100
# epochs, on the JAX package's seed-42 CAE) and three port assessors from
# seeds 42, 7 and 3, each under the adversarial inverter and the p5 swarm
# at the shipped epochs, all TF32. JAX_CAE as in rerun_cmd.sh.
set -u
JAX_CAE=${JAX_CAE:-_archive/jax_cae/00001--cae}
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
mkdir -p chiprun_out/assessors
PYTHONPATH=. python3 experiments_torch/chain_probe.py --cae "$JAX_CAE" --dims 10 --gan-epochs 100 --assessors 42 7 3 --out chiprun_out/assessors > chiprun_out/assessors/probe.log 2>&1
echo "rc=$?"
grep -E "^\{|chain_probe\]" chiprun_out/assessors/probe.log | cut -c1-2500
tail -3 chiprun_out/assessors/probe.log
