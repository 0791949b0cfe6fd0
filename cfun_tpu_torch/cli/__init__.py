"""Command-line entry points of the port, mirroring ``cfun_tpu/cli``
(the reference's heart_main / LiTS_main): ``train``, ``test``, ``submit``
and LiTS' ``preprocess``."""

from typing import Optional, Tuple


def parse_mesh(spec: Optional[str]) -> Optional[Tuple[int, int]]:
    """'DATA[,SPACE]' -> (data, space), the ``--mesh`` value of the
    trainer (``train_model(mesh_spec=...)``)."""
    if not spec:
        return None
    parts = [int(p) for p in spec.split(",")]
    if len(parts) not in (1, 2) or any(p < 1 for p in parts):
        raise ValueError(f"--mesh expects DATA[,SPACE], got {spec!r}")
    return (parts[0], parts[1] if len(parts) == 2 else 1)


def require_mesh(parser, spec: Optional[str], device: str
                 ) -> Optional[Tuple[int, int]]:
    """``--mesh`` parsed.  On CUDA each of its DATA x SPACE ranks takes a
    card of its own (NCCL): with fewer cards visible, stop with an error
    (exit code 2) that names how many there are, rather than train on
    fewer.  On the CPU (``--device cpu``) the ranks are gloo processes."""
    import torch

    from cfun_tpu_torch.parallel.mesh import rank_devices

    try:
        mesh = parse_mesh(spec)
    except ValueError as e:
        parser.error(str(e))
    if mesh is not None and torch.device(device).type == "cuda":
        try:
            rank_devices(mesh[0] * mesh[1], "cuda")
        except ValueError as e:
            parser.error(f"--mesh {spec}: {e}")
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
