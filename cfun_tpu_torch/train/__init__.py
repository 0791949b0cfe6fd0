"""Training of the port: the six losses, the detection targets, the SGD
step and the epoch loop (``cfun_tpu/train/``)."""
