# The rerun of the reference chain recorded in this directory, on one CUDA
# card, from the repository root: the z-10 chain at the shipped epochs
# (records under experiments_torch/rerun/), the z-2 legs on the same
# upstream legs, then the port's dcgan (z 10 and z 2, 100 epochs, TF32) on
# the JAX package's seed-42 CAE.
#
# JAX_CAE is that CAE's models dir. The card's host has no JAX, so it is
# made on a CPU first:
#   PYTHONPATH=. JAX_PLATFORMS=cpu python experiments_torch/cpu_swap.py jax-cae OUT
# writes OUT/jax-cae/model/mnist/00001--cae; copy that dir to $JAX_CAE
# (default _archive/jax_cae/00001--cae, a gitignored dir of the checkout).
set -u
JAX_CAE=${JAX_CAE:-_archive/jax_cae/00001--cae}
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
mkdir -p chiprun_out/rerun_logs
t0=$(date +%s)
GDPT_DIMS=10 python3 -c "import sys; from pathlib import Path; from gan_discovery_pso_tpu_torch.tools import run_experiment as r; sys.exit(r.main(root=Path('experiments_torch/rerun'), deadline_min=60))" > chiprun_out/rerun_logs/z10.log 2>&1
echo "z10 rc=$? $(( $(date +%s) - t0 )) s"
t1=$(date +%s)
GDPT_DIMS=2 python3 -c "import sys; from pathlib import Path; from gan_discovery_pso_tpu_torch.tools import run_experiment as r; sys.exit(r.main(only={'cae','classifiers','cnn_multipatient','dcgan_z2','pso_z2'}, root=Path('experiments_torch/rerun')))" > chiprun_out/rerun_logs/z2.log 2>&1
echo "z2 rc=$? $(( $(date +%s) - t1 )) s"
t2=$(date +%s)
PYTHONPATH=. python3 experiments_torch/chain_probe.py --cae "$JAX_CAE" --dims 10 2 --gan-epochs 100 --out chiprun_out/chain_probe_jaxcae > chiprun_out/rerun_logs/probe_jaxcae.log 2>&1
echo "probe rc=$? $(( $(date +%s) - t2 )) s"
tar -C experiments_torch --exclude=runs --exclude=failed_runs -cf - rerun | tar -C chiprun_out -xf -
tail -3 chiprun_out/rerun_logs/z10.log chiprun_out/rerun_logs/z2.log
grep "^{" chiprun_out/rerun_logs/probe_jaxcae.log | cut -c1-3000
