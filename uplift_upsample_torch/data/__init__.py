"""Host data code of the serving path (numpy): joint orders, windowing, batching."""
