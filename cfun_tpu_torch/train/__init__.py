"""Training of the port: the six losses, the detection targets and one
SGD step (``cfun_tpu/train/``).  The loop is not ported yet."""
