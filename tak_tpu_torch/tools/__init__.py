"""The counterparts of the repository's `tools/` scripts, each run as
`python -m tak_tpu_torch.tools.<name>`, on the CUDA device unless `--cpu`
is given: the search-strength guardrails (`strength_ab`,
`quality_recycle`, `quality_control`, `quality_k`), the profiling
harnesses (`profile_*`, on `timing.py`) and `diag_bn_mismatch`."""
