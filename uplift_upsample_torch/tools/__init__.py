"""Command-line tools of the port: checkpoint conversion and the full-scale eval
rehearsal (`python -m uplift_upsample_torch.tools.<name>`)."""
