"""The search-strength guardrails (counterparts of the repository's
`tools/strength_ab.py`, `tools/quality_recycle.py`,
`tools/quality_control.py` and `tools/quality_k.py`), each run as
`python -m tak_tpu_torch.tools.<name>`: on the CUDA device unless `--cpu`
is given."""
