# The assessor half of the checkpoint swap, on one CUDA card, from the
# repository root: one G (the port's dcgan z 10, 100 epochs, TF32, on the
# JAX package's seed-42 CAE), then the port's adversarial inverter and p5
# swarm at the shipped epochs (TF32) on two assessors trained on a CPU from
# one init and one batch order, one by each package:
#   PYTHONPATH=. JAX_PLATFORMS=cpu python experiments_torch/cpu_swap.py assessor OUT jax
#   PYTHONPATH=. JAX_PLATFORMS=cpu python experiments_torch/cpu_swap.py assessor OUT port
# JAX_ASSESSOR and PORT_ASSESSOR are their models dirs,
# OUT/cnn_multipatient/<package>/model/mnist/00001--cnn_multipatient, copied
# into the checkout (default under _archive/, gitignored). JAX_CAE as in
# rerun_cmd.sh.
set -u
JAX_CAE=${JAX_CAE:-_archive/jax_cae/00001--cae}
JAX_ASSESSOR=${JAX_ASSESSOR:-_archive/cpu_assessors/jax}
PORT_ASSESSOR=${PORT_ASSESSOR:-_archive/cpu_assessors/port}
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
mkdir -p chiprun_out/swap
PYTHONPATH=. python3 experiments_torch/chain_probe.py --cae "$JAX_CAE" --dims 10 --gan-epochs 100 --cnn "$JAX_ASSESSOR" "$PORT_ASSESSOR" --out chiprun_out/swap > chiprun_out/swap/probe.log 2>&1
echo "rc=$?"
grep -E "^\{|chain_probe\]" chiprun_out/swap/probe.log | cut -c1-2500
tail -3 chiprun_out/swap/probe.log
