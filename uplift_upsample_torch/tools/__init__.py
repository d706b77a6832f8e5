"""Command-line tools of the port: checkpoint conversion, the full-scale eval
rehearsal, the multi-rank dry run, and the matmul-precision drift simulator
and drift matrix (`python -m uplift_upsample_torch.tools.<name>`)."""
