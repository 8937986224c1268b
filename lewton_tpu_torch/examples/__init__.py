"""Command-line examples of lewton_tpu_torch, run with ``python -m``:
``lewton_tpu_torch.examples.player`` (decode to WAV, or a paced raw
stream) and ``lewton_tpu_torch.examples.perf`` (decode speed)."""
