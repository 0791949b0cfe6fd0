"""The port's data layer against the JAX package, on the CPU: NIfTI IO,
metrics, datasets, the LiTS preprocess cache and checkpoint loading
(native .npz strict and key-filtered, reference PyTorch state_dicts).

Criteria: NIfTI data and affines equal across the packages and the two
packages' files byte-equal (the gzip header's clock frozen); metrics
equal; dataset volumes and masks bit-equal; the .npy caches byte-equal;
parameter trees equal leaf by leaf.
"""

import json
import os
import struct
import time

import numpy as np
import pytest
import torch

from cfun_tpu import config as jconfig
from cfun_tpu.data import datasets as jdatasets
from cfun_tpu.data import nifti as jnifti
from cfun_tpu.data.preprocess_lits import MEAN_SPACING
from cfun_tpu.data.preprocess_lits import preprocess as jpreprocess
from cfun_tpu.utils import checkpoint as jcheckpoint
from cfun_tpu.utils import metrics as jmetrics
from cfun_tpu.utils import torch_convert as jtc
from cfun_tpu_torch import config as pconfig
from cfun_tpu_torch import weights
from cfun_tpu_torch.data import datasets as pdatasets
from cfun_tpu_torch.data import nifti as pnifti
from cfun_tpu_torch.data.preprocess_lits import preprocess as ppreprocess
from cfun_tpu_torch.utils import checkpoint as pcheckpoint
from cfun_tpu_torch.utils import metrics as pmetrics
from torch_port_params import jax_params


def _affine(seed):
    """A rotated, anisotropic, shifted affine (float32-exact entries)."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    aff = np.eye(4)
    aff[:3, :3] = q * rng.uniform(0.5, 2.5, size=3)
    aff[:3, 3] = rng.uniform(-100, 100, size=3)
    return aff.astype(np.float32).astype(np.float64)


def _volume(dtype, seed=0, shape=(13, 9, 7)):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        return rng.normal(0, 100, size=shape).astype(dtype)
    info = np.iinfo(dtype)
    lo, hi = max(info.min, -3000), min(info.max, 3000)
    return rng.integers(lo, hi, size=shape, endpoint=True).astype(dtype)


def _trees_equal(got, want):
    g, w = weights._leaves(got), weights._leaves(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype == torch.float32, k
        assert torch.equal(g[k], w[k]), k


# ---- NIfTI -----------------------------------------------------------------

@pytest.mark.parametrize("ext", [".nii", ".nii.gz"])
@pytest.mark.parametrize("dtype", [np.int16, np.int32, np.uint8, np.float32])
def test_nifti_round_trips_across_packages(tmp_path, monkeypatch, dtype,
                                           ext):
    """A file one package writes reads back in the other with equal data
    and affine, and the two packages' files of the same array are
    byte-equal (same name, the gzip header's clock frozen)."""
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    vol, aff = _volume(dtype), _affine(1)
    paths = {}
    for tag, mod in (("jax", jnifti), ("port", pnifti)):
        os.makedirs(tmp_path / tag)
        paths[tag] = str(tmp_path / tag / f"vol{ext}")
        mod.save(paths[tag], vol, aff)
    for reader, writer in ((pnifti, "jax"), (jnifti, "port")):
        data, affine = reader.load(paths[writer])
        assert data.dtype == vol.dtype
        np.testing.assert_array_equal(data, vol)
        np.testing.assert_array_equal(affine, aff)
    with open(paths["jax"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read()


def _patched(path, out, **fields):
    """A copy of the .nii file ``path`` with header fields rewritten."""
    raw = bytearray(open(path, "rb").read())
    offsets = {"scl": ("<2f", 112), "codes": ("<2h", 252),
               "quatern": ("<6f", 256), "pixdim": ("<8f", 76)}
    for name, values in fields.items():
        fmt, off = offsets[name]
        struct.pack_into(fmt, raw, off, *values)
    with open(out, "wb") as f:
        f.write(bytes(raw))
    return out


@pytest.mark.parametrize("case", ["qform", "qform_negative_qfac", "scaled",
                                  "no_transform"])
def test_nifti_headers_read_alike(tmp_path, case):
    """Files the packages' save never writes: a quaternion (qform-only)
    affine, with qfac -1, scl_slope / scl_inter scaling, and neither
    sform nor qform (pixdim alone)."""
    vol = _volume(np.int16, 3)
    base = str(tmp_path / "base.nii")
    jnifti.save(base, vol, np.diag([0.8, 0.9, 2.5, 1.0]))
    b, c, d = 0.1, -0.3, 0.2
    pixdim = (-1.0 if case == "qform_negative_qfac" else 1.0,
              0.8, 0.9, 2.5, 1, 1, 1, 1)
    fields = {
        "qform": dict(codes=(1, 0), quatern=(b, c, d, 10.0, -5.0, 3.0)),
        "qform_negative_qfac": dict(codes=(1, 0), pixdim=pixdim,
                                    quatern=(b, c, d, 10.0, -5.0, 3.0)),
        "scaled": dict(scl=(2.0, -7.5)),
        "no_transform": dict(codes=(0, 0)),
    }[case]
    path = _patched(base, str(tmp_path / "case.nii"), **fields)
    jd, ja = jnifti.load(path)
    pd, pa = pnifti.load(path)
    assert pd.dtype == jd.dtype
    np.testing.assert_array_equal(pd, jd)
    np.testing.assert_array_equal(pa, ja)
    if case == "scaled":
        np.testing.assert_array_equal(pd, vol.astype(np.float32) * 2 - 7.5)


# ---- metrics ---------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_match_jax(seed):
    """Seeded label pairs; class 4 is absent from both volumes and class 3
    from the prediction."""
    rng = np.random.default_rng(seed)
    gt = rng.integers(0, 4, size=(20, 18, 11)).astype(np.int32)
    pred = np.where(rng.uniform(size=gt.shape) < 0.8, gt,
                    rng.integers(0, 3, size=gt.shape)).astype(np.int16)
    pred[pred == 3] = 0
    for fn in ("per_class_mask_iou", "per_class_dice"):
        got = getattr(pmetrics, fn)(gt, pred, 5)
        want = getattr(jmetrics, fn)(gt, pred, 5)
        np.testing.assert_array_equal(got, want)
        assert got[3] == 0.0 and got.shape == (4,)
    assert pmetrics.whole_mask_iou(gt, pred) == \
        jmetrics.whole_mask_iou(gt, pred)


# ---- datasets --------------------------------------------------------------

@pytest.mark.parametrize("n_fg,host_shape", [(7, (30, 28, 16)),
                                             (3, (24, 24, 12))])
def test_synthetic_dataset_matches_jax(n_fg, host_shape):
    jds = jdatasets.SyntheticDataset(jconfig.tiny_config(num_classes=8), n=3,
                                     seed=3000, host_shape=host_shape,
                                     n_fg=n_fg)
    pds = pdatasets.SyntheticDataset(pconfig.tiny_config(num_classes=8),
                                     n=3, seed=3000, host_shape=host_shape,
                                     n_fg=n_fg)
    assert pds.num_images == jds.num_images == 3
    assert pds.class_names == jds.class_names
    for i in range(3):
        np.testing.assert_array_equal(pds.load_image(i), jds.load_image(i))
        np.testing.assert_array_equal(pds.load_mask(i), jds.load_mask(i))
        np.testing.assert_array_equal(pds.load_affine(i),
                                      jds.load_affine(i))


def _write_heart_tree(root, n=4):
    """A manifest dataset (tests/test_cli_integration.py's fixture), with
    relative, absolute and moved paths in the manifest."""
    rng = np.random.default_rng(0)
    items = []
    for i in range(n):
        label = np.zeros((20, 18, 10), np.int16)
        label[4:14, 5:15, 2:8] = 1 + i % 3
        image = rng.normal(0, 40, size=label.shape).astype(np.float32)
        image += 300.0 * (label > 0)
        jnifti.save(os.path.join(root, f"img_{i}.nii.gz"),
                    image.astype(np.int16), _affine(i))
        jnifti.save(os.path.join(root, f"lbl_{i}.nii.gz"), label,
                    _affine(i))
        img = (f"img_{i}.nii.gz" if i % 2 else
               os.path.join(root, f"img_{i}.nii.gz"))
        lbl = f"/elsewhere/lbl_{i}.nii.gz" if i == 3 else f"lbl_{i}.nii.gz"
        items.append({"image": img, "label": lbl})
    with open(os.path.join(root, "dataset.json"), "w") as f:
        json.dump({"train_and_test": items}, f)


@pytest.mark.parametrize("subset", ["train", "val", "all"])
def test_heart_dataset_matches_jax(tmp_path, subset):
    _write_heart_tree(str(tmp_path))
    jds, pds = jdatasets.HeartDataset(), pdatasets.HeartDataset()
    for ds in (jds, pds):
        ds.load_heart(str(tmp_path), subset, val_size=1)
        ds.prepare()
    assert pds.num_images == jds.num_images == {"train": 3, "val": 1,
                                                "all": 4}[subset]
    assert pds.num_classes == jds.num_classes == 8
    assert pds.image_info == jds.image_info
    for i in range(pds.num_images):
        np.testing.assert_array_equal(pds.load_image(i), jds.load_image(i))
        np.testing.assert_array_equal(pds.load_mask(i), jds.load_mask(i))
        np.testing.assert_array_equal(pds.load_affine(i),
                                      jds.load_affine(i))
    label = pds.load_mask(0)
    got, gids = pdatasets.HeartDataset.process_mask(label)
    want, wids = jdatasets.HeartDataset.process_mask(label)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gids, wids)


def test_lits_dataset_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    for sub in ("image_np", "label_np"):
        os.makedirs(tmp_path / sub)
    for i in (0, 5, 111, 130):  # train and val indices, with gaps
        np.save(tmp_path / "image_np" / f"liver_{i}.npy",
                rng.normal(size=(9, 8, 5)).astype(np.float32))
        np.save(tmp_path / "label_np" / f"liver_label_{i}.npy",
                rng.integers(0, 3, size=(9, 8, 5)).astype(np.int8))
    for subset, n in (("train", 2), ("val", 2), ("all", 4)):
        jds, pds = jdatasets.LiTSDataset(), pdatasets.LiTSDataset()
        for ds in (jds, pds):
            ds.load_lits(str(tmp_path), subset)
            ds.prepare()
        assert pds.num_images == jds.num_images == n
        assert pds.image_info == jds.image_info
        assert pds.class_names == jds.class_names
        for i in range(n):
            np.testing.assert_array_equal(pds.load_image(i),
                                          jds.load_image(i))
            np.testing.assert_array_equal(pds.load_mask(i),
                                          jds.load_mask(i))


# ---- LiTS preprocess -------------------------------------------------------

def _raw_volume(shape_hwd=(40, 40, 24), seed=0):
    """tests/test_lits_cli_integration.py's HU phantom."""
    rng = np.random.default_rng(seed)
    label = np.zeros(shape_hwd, np.int16)
    label[10:30, 10:30, 6:18] = 1
    label[16:24, 16:24, 9:15] = 2
    image = np.full(shape_hwd, 300.0, np.float32)
    image += rng.normal(0, 40, size=shape_hwd).astype(np.float32)
    image[label == 1] = -150.0
    image[label == 2] = -280.0
    return image, label


@pytest.mark.parametrize("spacing", ["mean", "anisotropic"])
def test_preprocess_caches_byte_equal(tmp_path, spacing):
    """The raw tree of tests/test_lits_cli_integration.py (at the mean
    spacing, where the resample keeps the shape, and at another spacing,
    where it resizes every axis); both packages' caches byte-equal."""
    raw = tmp_path / "raw"
    zooms = (list(MEAN_SPACING) if spacing == "mean"
             else [0.7, 0.95, 2.5])
    affine = np.diag(zooms + [1.0])
    for sub in ("imagesTr", "labelsTr", "imagesTs"):
        os.makedirs(raw / sub)
    for i in (0, 2):
        image, label = _raw_volume(seed=i)
        jnifti.save(str(raw / "imagesTr" / f"volume-{i}.nii.gz"),
                    image.astype(np.int16), affine)
        jnifti.save(str(raw / "labelsTr" / f"segmentation-{i}.nii.gz"),
                    label, affine)
    timage, _ = _raw_volume(seed=7)
    jnifti.save(str(raw / "imagesTs" / "test-volume-0.nii.gz"),
                timage.astype(np.int16), affine)
    jpreprocess(str(raw), str(tmp_path / "jax"), n_train=3, n_test=1)
    ppreprocess(str(raw), str(tmp_path / "port"), n_train=3, n_test=1)
    names = []
    for sub in ("image_np", "label_np", "image_test_np"):
        got = sorted(os.listdir(tmp_path / "port" / sub))
        assert got == sorted(os.listdir(tmp_path / "jax" / sub))
        names += [os.path.join(sub, n) for n in got]
    assert len(names) == 5
    for name in names:
        with open(tmp_path / "jax" / name, "rb") as a, \
                open(tmp_path / "port" / name, "rb") as b:
            assert a.read() == b.read(), name
    shape = np.load(tmp_path / "port" / "image_np" / "liver_0.npy").shape
    assert (shape == (40, 40, 24)) == (spacing == "mean")


# ---- checkpoints -----------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_trees():
    jcfg, pcfg = jconfig.tiny_config(), pconfig.tiny_config()
    return jcfg, pcfg, jax_params(jcfg, 11)


@pytest.mark.parametrize("store", ["f32", "f16_compressed"])
def test_load_any_native_npz_matches_jax(tmp_path, tiny_trees, store):
    """A JAX-written checkpoint through the port's ``load_any`` (strict)
    equals ``params_from_numpy`` of the JAX package's own load."""
    jcfg, pcfg, jp = tiny_trees
    path = str(tmp_path / "ckpt.npz")
    kw = (dict(store_dtype=np.float16, compress=True)
          if store == "f16_compressed" else {})
    jcheckpoint.save(path, jp, epoch=3, step=7, meta={"tag": "t"}, **kw)
    want, _, jmeta = jcheckpoint.load_any(path, jcfg, jp, strict=True)
    got, opt, meta = pcheckpoint.load_any(
        path[:-4], pcfg, weights.init_params(pcfg, seed=1), strict=True)
    assert opt is None
    assert meta == jmeta == {"epoch": 3, "step": 7, "tag": "t"}
    _trees_equal(got, weights.params_from_numpy(want, pcfg))


def _tiny_lits(mod, stage):
    """tests/test_lits_variant.py's ``_tiny_lits``."""
    return mod.tiny_config(stage).replace(
        name="lits", num_classes=3, backbone="P3D35",
        intensity_norm="hu_window", pad_shape=(64, 128, 128),
        mask_class_weights=(1.0, 1.0, 100.0), unet_dropout_rate=0.0,
        mask_shape_override=(16, 16, 16), mask_pool_size=(16, 16, 16))


def test_load_key_filtered_stage_transfer_matches_jax(tmp_path):
    """A tiny LiTS 'beginning' checkpoint that lacks the mask branch,
    holds a key the tree does not have and one leaf of another shape,
    loaded into a 'finetune' template with strict=False by both packages:
    equal trees leaf by leaf (the missing and misshapen leaves keep the
    template's values)."""
    jcfg, pcfg = _tiny_lits(jconfig, "finetune"), _tiny_lits(pconfig,
                                                            "finetune")
    template = jax_params(jcfg, 21)
    stored = jax_params(_tiny_lits(jconfig, "beginning"), 22)
    del stored["mask"]
    stored["extra"] = {"w": np.ones((2, 3), np.float32)}
    stored["rpn"]["cls"]["b"] = np.zeros(5, np.float32)
    path = str(tmp_path / "beginning.npz")
    jcheckpoint.save(path, stored, meta={"stage": "beginning"})
    want, _, _ = jcheckpoint.load_any(path, jcfg, template)
    got, _, meta = pcheckpoint.load_any(
        path, pcfg, weights.params_from_numpy(template, pcfg))
    assert meta["stage"] == "beginning"
    _trees_equal(got, weights.params_from_numpy(want, pcfg))
    flat = weights._flatten(got)
    np.testing.assert_array_equal(flat["rpn/cls/b"],
                                  template["rpn"]["cls"]["b"])
    np.testing.assert_array_equal(
        flat["backbone/stem_conv/w"],
        stored["backbone"]["stem_conv"]["w"].transpose(4, 3, 0, 1, 2))


@pytest.mark.parametrize("fault", ["shape", "missing"])
def test_load_strict_raises(tmp_path, tiny_trees, fault):
    jcfg, pcfg, jp = tiny_trees
    tree = jax_params(jcfg, 12)
    if fault == "shape":
        tree["fpn"]["p3_conv2"]["b"] = np.zeros(3, np.float32)
    else:
        del tree["classifier"]["bn1"]["var"]
    path = str(tmp_path / "bad.npz")
    jcheckpoint.save(path, tree)
    template = weights.init_params(pcfg, seed=0)
    with pytest.raises(ValueError if fault == "shape" else KeyError):
        pcheckpoint.load(path, template, strict=True)
    with pytest.raises(ValueError if fault == "shape" else KeyError):
        jcheckpoint.load(path, jp, strict=True)
    got, _, _ = pcheckpoint.load(path, template, strict=False)
    leaf = ("fpn/p3_conv2/b" if fault == "shape"
            else "classifier/bn1/var")
    assert torch.equal(weights._leaves(got)[leaf],
                       weights._leaves(template)[leaf])


def _reference_state_dict(tree, cfg):
    """The inverse of the JAX package's ``maskrcnn_from_torch``: a
    reference-style ``state_dict`` (torch layouts and module names) whose
    conversion is ``tree``, with the BN buffers the reference also
    saves."""
    sd = {}

    def conv(p, name, bias=True):
        w = p["w"]
        sd[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(
            w.transpose(4, 3, 0, 1, 2) if w.ndim == 5 else w.T))
        if bias:
            sd[f"{name}.bias"] = torch.from_numpy(p["b"])

    def bn(p, name):
        for ours, theirs in (("scale", "weight"), ("bias", "bias"),
                             ("mean", "running_mean"),
                             ("var", "running_var")):
            sd[f"{name}.{theirs}"] = torch.from_numpy(p[ours])
        sd[f"{name}.num_batches_tracked"] = torch.tensor(0)

    b = tree["backbone"]
    conv(b["stem_conv"], "fpn.C1.0")
    bn(b["stem_bn"], "fpn.C1.1")
    for stage in (2, 3):
        for i, blk in enumerate(b[f"c{stage}"]):
            pre = f"fpn.C{stage}.{i}"
            for ours, theirs, fn in jtc._BOTTLENECK_MAP:
                (conv if fn is jtc._conv else bn)(blk[ours],
                                                  f"{pre}.{theirs}")
            if "down_conv" in blk:
                conv(blk["down_conv"], f"{pre}.downsample.0")
                bn(blk["down_bn"], f"{pre}.downsample.1")
    for ours, theirs in (("p3_conv1", "P3_conv1"), ("p3_conv2", "P3_conv2"),
                         ("p2_conv1", "P2_conv1"), ("p2_conv2", "P2_conv2")):
        conv(tree["fpn"][ours], f"fpn.{theirs}")
    for ours, theirs in (("shared", "conv_shared"), ("cls", "conv_class"),
                         ("bbox", "conv_bbox")):
        conv(tree["rpn"][ours], f"rpn.{theirs}")
    c = tree["classifier"]
    conv(c["conv1"], "classifier.conv1")
    bn(c["bn1"], "classifier.bn1")
    conv(c["conv2"], "classifier.conv2")
    bn(c["bn2"], "classifier.bn2")
    conv(c["cls"], "classifier.linear_class")
    conv(c["bbox"], "classifier.linear_bbox")
    for ours, theirs in jtc._UNET_MAP:
        conv(tree["mask"]["unet"][ours], f"mask.modified_u_net.{theirs}",
             bias=False)
    return sd


@pytest.mark.parametrize("which", ["heart", "lits"])
def test_load_any_reference_torch_checkpoint_matches_jax(tmp_path, which):
    """A reference-style state_dict saved with ``torch.save`` loads
    through both packages' ``load_any`` (detected by content, no .npz
    suffix) to equal trees, which are the tree it was made from."""
    if which == "heart":
        jcfg, pcfg = jconfig.tiny_config(), pconfig.tiny_config()
    else:
        jcfg, pcfg = (_tiny_lits(jconfig, "finetune"),
                      _tiny_lits(pconfig, "finetune"))
    tree = jax_params(jcfg, 31)
    path = str(tmp_path / "reference.pth")
    torch.save(_reference_state_dict(tree, jcfg), path)
    assert not pcheckpoint._is_native_npz(path)
    want, _, jmeta = jcheckpoint.load_any(path, jcfg, None)
    got, opt, meta = pcheckpoint.load_any(path, pcfg,
                                          weights.init_params(pcfg, seed=0))
    assert opt is None
    assert meta == jmeta == {"source": "torch", "path": path}
    _trees_equal(got, weights.params_from_numpy(want, pcfg))
    _trees_equal(got, weights.params_from_numpy(tree, pcfg))


def test_reference_conversion_checks_the_layout(tmp_path):
    """A state_dict for another width is refused against ``layout(cfg)``,
    and one missing a parameter raises."""
    from cfun_tpu_torch.utils import torch_convert

    jcfg = jconfig.tiny_config(fpn_channels=8)
    sd = _reference_state_dict(jax_params(jcfg, 1), jcfg)
    with pytest.raises(ValueError, match="shapes"):
        torch_convert.maskrcnn_from_torch(sd, pconfig.tiny_config())
    del sd["rpn.conv_bbox.bias"]
    with pytest.raises(KeyError):
        torch_convert.maskrcnn_from_torch(
            sd, pconfig.tiny_config(fpn_channels=8))
