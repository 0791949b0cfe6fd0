"""Command-line entry points of the port, mirroring ``cfun_tpu/cli``
(the reference's heart_main / LiTS_main): ``train``, ``test``, ``submit``
and LiTS' ``preprocess``."""

from typing import Optional, Tuple


def parse_mesh(spec: Optional[str]) -> Optional[Tuple[int, int]]:
    """'DATA[,SPACE]' -> (data, space), the ``--mesh`` value of the
    trainer.  ``train_model`` takes one device (data * space == 1);
    training over several devices is not ported yet."""
    if not spec:
        return None
    parts = [int(p) for p in spec.split(",")]
    if len(parts) not in (1, 2) or any(p < 1 for p in parts):
        raise ValueError(f"--mesh expects DATA[,SPACE], got {spec!r}")
    return (parts[0], parts[1] if len(parts) == 2 else 1)


def require_one_device(parser, spec: Optional[str]
                       ) -> Optional[Tuple[int, int]]:
    """``--mesh`` parsed; stop with an error (exit code 2) when it asks for
    more than one device: multi-device training is not yet ported
    (ROADMAP.md A.6)."""
    try:
        mesh = parse_mesh(spec)
    except ValueError as e:
        parser.error(str(e))
    if mesh is not None and mesh[0] * mesh[1] > 1:
        parser.error(f"--mesh {spec}: multi-device training is not yet "
                     "ported (ROADMAP.md A.6); train on one device")
    return mesh


def require_device(parser, device: str) -> None:
    """Stop with an error (exit code 2) when ``device`` is CUDA and there
    is no card: the commands do not carry on on the CPU unless asked."""
    import torch

    if torch.device(device).type == "cuda" and \
            not torch.cuda.is_available():
        parser.error("no CUDA device; pass --device cpu to run on the CPU")


def inference_params(cfg, weights_arg: str) -> dict:
    """The parameter tree ``test`` and ``submit`` serve: seeded random
    (``weights.init_params(cfg, seed=0)``; it cannot equal the JAX
    package's ``PRNGKey(0)`` init) for 'none', else that template filled
    from the checkpoint by ``checkpoint.load_any`` (a native .npz,
    key-filtered, or a reference PyTorch checkpoint)."""
    from cfun_tpu_torch import weights
    from cfun_tpu_torch.utils import checkpoint

    params = weights.init_params(cfg, seed=0)
    if weights_arg.lower() != "none":
        params, _, meta = checkpoint.load_any(weights_arg, cfg, params)
        print(f"Weights loaded: {weights_arg} ({meta.get('source', 'npz')})")
    return params
