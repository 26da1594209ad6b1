"""Command-line tools of the port: ``convert_checkpoint`` (a reference torch
checkpoint to the ``.npz`` format) and ``export_serving`` (the serving
graphs as ``torch.export`` artifacts)."""
