"""Data code: joint orders, loaders, windowing and batching for serving, eval and
training (numpy, host side), and the device-resident train feed."""
