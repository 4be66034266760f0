"""Command-line interface of the port: ``python -m raider_tpu_torch.cli``."""
