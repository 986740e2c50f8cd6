"""playtak.com client: wire protocol and bot (counterpart of `tak_tpu/playtak/`)."""
