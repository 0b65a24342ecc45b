"""Runnable demos of the port (counterparts of the repository's root
`examples/`): `python -m sam2_opt_tpu_torch.examples.<name> --help`."""
