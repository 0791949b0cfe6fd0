"""Shared weights for the port's A/B tests: the JAX package's parameter
tree (structure and shapes from ``cfun.init_params``), filled from a numpy
seed.  Tracing ``init_params`` for its shapes is cheap; running it on the
CPU costs tens of seconds per configuration.

Conv weights are Xavier-uniform as in ``nn.conv3d_init``; linears
N(0, 0.01); biases and frozen-BN statistics are random too, so the A/Bs
also hold the bias and BN paths.  The classifier's FG bias is raised so
random weights still produce detections above
``detection_min_confidence``.
"""

import jax
import numpy as np

from cfun_tpu.models import cfun as jcfun


def jax_params(cfg, seed=0):
    shapes = jax.eval_shape(lambda k: jcfun.init_params(k, cfg),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        shape = s.shape
        if name == "w" and len(shape) == 5:
            fan = np.prod(shape[:3]) * (shape[3] + shape[4])
            lim = np.sqrt(6.0 / fan)
            return rng.uniform(-lim, lim, shape).astype(np.float32)
        if name == "w":
            return (0.01 * rng.normal(size=shape)).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.8, 1.2, shape).astype(np.float32)
        return (0.05 * rng.normal(size=shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes)
    params["classifier"]["cls"]["b"] = np.array([0.0, 3.0], np.float32)
    return params
