"""Host-side utilities: Keras .h5 loading and the keyframe interpolation."""
