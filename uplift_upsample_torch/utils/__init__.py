"""Host-side utilities: Keras .h5 reading and writing, metrics and the eval protocol,
LR schedules, metric history and scalar logs."""
