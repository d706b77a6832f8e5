"""Host data code (numpy): joint orders, windowing and batching for serving and training."""
