"""Tiny configurations of both families for the benchmark's CPU tests: the
port's configurations shrunk to CPU size, in float32, with a confidence
limit of 0 so that seeded weights keep detections, and NMS thresholds low
enough that their boxes are suppressed at both sites (so a K1 that
suppresses nothing changes what is served)."""

from __future__ import annotations

import dataclasses
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))

HEART = dict(wire_image_dtype="int8", fast_unmold=True,
             device_normalize=True, detection_max_instances=1,
             detection_min_confidence=0.0, rpn_nms_threshold=0.3,
             detection_nms_threshold=0.1)
LITS = dict(image_shape=(32, 64, 64), backbone_channels=(4, 8),
            fpn_channels=16, rpn_conv_channels=16, fc_size=16,
            unet_base_channels=4, anchor_scales=(16, 32), pre_nms_limit=64,
            post_nms_rois_inference=8, pool_size=(4, 4, 4),
            mask_pool_size=(16, 16, 16), pad_shape=(40, 80, 80),
            detection_max_instances=3, compute_dtype="float32",
            detection_min_confidence=0.0, rpn_nms_threshold=0.3,
            detection_nms_threshold=0.1)
# limits of the tiny float32 runs: the program equals the reference there
# (every reading 0 but float32 rounding), the float8 control reads tens of
# percent of mismatched labels, a detection lost or moved its whole score
LIMITS = {"det_missed": 0.01, "det_unsupported": 0.01,
          "det_overlap_excess": 1e-6, "label_mismatch_pct": 1.0,
          "label_gap_mean": 0.001, "unmold_mismatch": 0}


def _model(cfg, keys):
    d = dataclasses.asdict(cfg)
    return {k: (list(d[k]) if isinstance(d[k], tuple) else d[k])
            for k in keys}


def config(family: str) -> dict:
    """A configuration file's content for the tiny ``family``."""
    from cfun_tpu_torch.config import lits_inference_config, tiny_config

    with open(os.path.join(ROOT, "portbench", "configs",
                           f"{family}.json")) as f:
        keys = json.load(f)["model"].keys()
    if family == "heart":
        factory, stage, over = "tiny_config", "beginning", HEART
        cfg = tiny_config(stage, **over)
        hw, depths = [48, 48], [20, 28]
    else:
        factory, stage, over = "lits_inference_config", "finetune", LITS
        cfg = lits_inference_config(stage, **over)
        hw, depths = [56, 56], [24, 36]
    return {"name": f"tiny-{family}",
            "serve": {"factory": factory, "stage": stage,
                      "overrides": {k: list(v) if isinstance(v, tuple) else v
                                    for k, v in over.items()},
                      "weights": "seed",
                      "volumes": {"generator": family, "hw": hw,
                                  "depths": depths},
                      "limits": dict(LIMITS)},
            "model": _model(cfg, keys)}


def traffic() -> dict:
    with open(os.path.join(ROOT, "portbench", "traffic",
                           "serve_closed.json")) as f:
        out = json.load(f)
    out["trace_requests"] = 4
    return out
