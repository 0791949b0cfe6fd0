"""Inference entry point of the port."""

from cfun_tpu_torch.inference.pipeline import Detector  # noqa: F401
