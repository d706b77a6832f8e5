"""Host-side utilities: Keras .h5 loading, keyframe interpolation, LR schedules."""
