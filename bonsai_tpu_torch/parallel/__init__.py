"""The sharded classifier and its mesh (``bonsai_tpu/parallel/``)."""
