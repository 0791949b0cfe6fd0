"""ROI heads: FG/BG classifier + box regressor, and the U-Net mask head
(port of ``cfun_tpu/models/heads.py``).

Classifier: pyramid-RoIAligned [C x 12^3] crop -> full-window conv (one
matmul over the flattened crop) -> BN -> ReLU -> 1^3 conv -> BN -> ReLU ->
two linears: 2-way FG/BG logits and per-class 6-deltas.  The mask head
runs the Modified 3D U-Net over a crop of the raw 1-channel input volume.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from cfun_tpu_torch import nn
from cfun_tpu_torch.models.unet3d import apply_unet, apply_unet_fused


def apply_classifier(params: nn.Params, pooled: torch.Tensor,
                     dtype=torch.float32
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """pooled: [N, C, pd, ph, pw] -> (class_logits [N, 2] f32,
    deltas [N, 2, 6] f32)."""
    n = pooled.shape[0]
    w = params["conv1"]["w"]  # [fc, C, pd, ph, pw]
    x = pooled.reshape(n, -1).to(dtype) @ w.reshape(w.shape[0], -1).to(dtype).T
    x = (x + params["conv1"]["b"].to(dtype))[:, :, None, None, None]
    x = nn.relu(nn.frozen_bn(params["bn1"], x, eps=1e-3))
    x = nn.relu(nn.frozen_bn(params["bn2"],
                             nn.conv3d(params["conv2"], x, dtype=dtype),
                             eps=1e-3))
    x = x.reshape(n, -1)
    logits = nn.linear(params["cls"], x, dtype=dtype).float()
    deltas = nn.linear(params["bbox"], x, dtype=dtype).float()
    return logits, deltas.reshape(n, 2, 6)


def apply_mask_head(params: nn.Params, crops: torch.Tensor, *, stage: str,
                    dropout_rate: float = 0.0,
                    dropout_masks: Optional[Sequence[torch.Tensor]] = None,
                    dtype=torch.float32, fused: bool = False,
                    head_impl: str = "phase",
                    up_impl: str = "phase") -> torch.Tensor:
    """crops: [N, 1, D, H, W] raw-image crops -> logits
    [N, num_classes, D', H', W'] in ``dtype`` (D' = 2D at 'finetune').

    ``fused=True`` (``Config.pallas_unet``, inference only): the fused
    U-Net (``models/unet3d.py::apply_unet_fused``), which computes in
    bfloat16, takes the phase head and has no dropout.  Otherwise the
    dense U-Net with ``dropout_rate`` and the five sites' keep masks
    ``dropout_masks``; ``head_impl`` / ``up_impl`` pick the finetune
    head's and the decoder up-convs' forms: 'phase' (the inference forms,
    the default) or 'explicit' (the train step's)."""
    if fused:
        # the fused kernel has no dropout path: refuse rather than change
        # what the graph computes
        if dropout_rate and dropout_masks is not None:
            raise ValueError("fused=True has no dropout path (inference "
                             "only); got dropout_rate > 0 with masks")
        if dtype != torch.bfloat16:
            raise ValueError(f"fused=True computes in bfloat16; config "
                             f"compute dtype is {dtype}")
        return apply_unet_fused(params["unet"], crops, stage=stage,
                                dtype=dtype)
    return apply_unet(params["unet"], crops, stage=stage,
                      dropout_rate=dropout_rate, dropout_masks=dropout_masks,
                      dtype=dtype, head_impl=head_impl, up_impl=up_impl)
