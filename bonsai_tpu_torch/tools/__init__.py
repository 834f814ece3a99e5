"""Command-line tools of the port (``python -m bonsai_tpu_torch.tools.<name>``)."""
