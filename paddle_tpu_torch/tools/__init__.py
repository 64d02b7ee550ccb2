"""Command-line tools of the port (``python -m paddle_tpu_torch.tools.<name>``):
``cost_ledger``, the device-cost ledger's probe fleet and baseline gate."""
