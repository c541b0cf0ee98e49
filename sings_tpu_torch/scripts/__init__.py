"""Entry points of the port's kernel experiments, one per script of
scripts/ that launches a kernel of its own: exp_bwd_moments,
exp_cumsum_kernel and exp_bwd_variants. Each runs as
python -m sings_tpu_torch.scripts.<name> [--device cuda|cpu]."""
