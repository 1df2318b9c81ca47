"""``pretrained_path`` (ImageNet encoder init) in the PyTorch port against the
JAX package's ``load_pretrained_encoder``, on the CPU.

ImageNet files cannot be fetched here, so each file is seeded with numpy in
its family's own layout, classifier top included: torchvision's resnet18
(``fc.*``), torchvision's mobilenet_v2 (``classifier.1.*``) and
efficientnet-pytorch's b0 (``_conv_head``, ``_bn1``, ``_fc``), as a bare
``.pth`` ``state_dict`` and as the ``.npz`` with torch key names that
``scripts/convert_torchvision_resnet18.py`` writes, plus a reference
checkpoint.  The port's encoder after the load equals the JAX package's
after its graft (mapped back through ``encoder_state_dict_from_jax``) and
the file's own tensors, bit for bit; a file that lacks a tensor raises on
both sides.  The ``Trainer`` loads the file after seeding the model and
before a resume, which overrides it; ``cli.train`` takes it on the new
backbones.
"""

import numpy as np
import pytest
import torch

from pdac_pathological_image_segmentation_tpu.data.synthetic import (
    generate_synthetic_patches,
)
from pdac_pathological_image_segmentation_tpu.models import (
    build_model as jax_build_model,
)
from pdac_pathological_image_segmentation_tpu.utils.torch_weights import (
    load_pretrained_encoder as jax_load_pretrained_encoder,
)
from pdac_pathological_image_segmentation_tpu_torch import Config
from pdac_pathological_image_segmentation_tpu_torch.data.discovery import (
    discover_split,
)
from pdac_pathological_image_segmentation_tpu_torch.data.loader import (
    PatchDataset,
)
from pdac_pathological_image_segmentation_tpu_torch.models import build_model
from pdac_pathological_image_segmentation_tpu_torch.models.encoders import (
    build_encoder,
)
from pdac_pathological_image_segmentation_tpu_torch.train.loop import Trainer
from pdac_pathological_image_segmentation_tpu_torch.utils.torch_weights import (
    encoder_state_dict_from_jax,
    load_pretrained_encoder,
    load_reference_state_dict,
    seeded_state_dict,
)

from torch_model_parity import (  # noqa: F401 (one_torch_thread)
    SIZE,
    assert_cli_train_and_resume,
    jax_cfg,
    np_tree,
    one_torch_thread,
    port_cfg,
    zero_variables,
)

BACKBONES = ("resnet18", "mobilenet_v2", "efficientnet-b0")


def classifier_top(backbone: str, rng) -> dict:
    """The ImageNet classifier each family's file carries beside its
    encoder."""
    def arr(*shape, scale=0.05):
        return rng.normal(0, scale, shape).astype(np.float32)

    if backbone == "resnet18":
        return {"fc.weight": arr(1000, 512), "fc.bias": arr(1000)}
    if backbone == "mobilenet_v2":
        return {"classifier.1.weight": arr(1000, 1280),
                "classifier.1.bias": arr(1000)}
    return {"_conv_head.weight": arr(1280, 320, 1, 1),
            "_bn1.weight": arr(1280), "_bn1.bias": arr(1280),
            "_bn1.running_mean": arr(1280),
            "_bn1.running_var": np.abs(arr(1280)) + 0.5,
            "_bn1.num_batches_tracked": np.asarray(3, np.int64),
            "_fc.weight": arr(1000, 1280), "_fc.bias": arr(1000)}


def encoder_file(backbone: str, path, seed: int = 0, drop: str = "") -> dict:
    """A seeded ImageNet-layout file at ``path`` (``.pth`` or ``.npz``):
    the encoder's tensors, each BN's ``num_batches_tracked``, the
    classifier top; without ``drop``.  Returns the encoder's tensors."""
    rng = np.random.default_rng(seed)
    enc = seeded_state_dict(build_encoder(backbone), seed=seed)
    arrays = {k: v.numpy() for k, v in enc.items()}
    arrays.update(classifier_top(backbone, rng))
    arrays.pop(drop, None)
    if str(path).endswith(".npz"):
        np.savez(path, **arrays)
    else:
        torch.save({k: torch.from_numpy(np.asarray(v))
                    for k, v in arrays.items()}, path)
    return {k: v for k, v in enc.items() if k != drop}


def jax_encoder_after_load(backbone: str, path) -> dict:
    """The JAX ``load_pretrained_encoder`` on an FPN's variables, mapped
    back to the port's encoder names (without ``num_batches_tracked``,
    which the JAX package does not keep)."""
    variables = zero_variables(jax_build_model(jax_cfg("fpn",
                                                       backbone=backbone)))
    params, batch_stats = jax_load_pretrained_encoder(
        str(path), variables["params"], variables["batch_stats"])
    sd = encoder_state_dict_from_jax(np_tree(params["encoder"]),
                                     np_tree(batch_stats["encoder"]), "")
    return {k: v for k, v in sd.items()
            if not k.endswith("num_batches_tracked")}


@pytest.mark.parametrize("fmt", ["pth", "npz"])
@pytest.mark.parametrize("backbone", BACKBONES)
def test_encoder_equals_jax_load_pretrained_encoder(backbone, fmt, tmp_path):
    path = tmp_path / f"{backbone}.{fmt}"
    want = encoder_file(backbone, path)
    model = build_model(port_cfg("fpn", backbone=backbone))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    load_pretrained_encoder(model, str(path))
    ours = model.encoder.state_dict()
    theirs = jax_encoder_after_load(backbone, path)
    assert sorted(theirs) == sorted(
        k for k in ours if not k.endswith("num_batches_tracked"))
    for k, v in theirs.items():
        assert torch.equal(ours[k], v), k
        assert torch.equal(ours[k], want[k]), k
    for k, v in model.state_dict().items():  # the decoder is untouched
        if not k.startswith("encoder."):
            assert torch.equal(v, before[k]), k


def test_reference_checkpoint_as_pretrained_file(tmp_path):
    """A reference checkpoint (``{"model": ...}`` with ``module.encoder.``
    keys and a decoder) gives its encoder, as on the JAX side."""
    backbone = "mobilenet_v2"
    src = build_model(port_cfg("deeplabv3+", backbone=backbone))
    sd = seeded_state_dict(src, seed=3)
    path = tmp_path / "ref.pth"
    torch.save({"model": {f"module.{k}": v for k, v in sd.items()},
                "epoch": 4, "previous_best": 0.3}, path)
    assert sorted(load_reference_state_dict(str(path))) == sorted(sd)
    model = build_model(port_cfg("fpn", backbone=backbone))
    load_pretrained_encoder(model, str(path))
    theirs = jax_encoder_after_load(backbone, path)
    for k, v in theirs.items():
        assert torch.equal(model.encoder.state_dict()[k], v), k
        assert torch.equal(v, sd[f"encoder.{k}"]), k


@pytest.mark.parametrize("backbone,drop", [
    ("resnet18", "layer4.1.bn2.running_var"),
    ("mobilenet_v2", "features.17.conv.1.0.weight"),
    ("efficientnet-b0", "_blocks.15._se_expand.bias")])
def test_a_file_that_lacks_a_tensor_raises_on_both_sides(backbone, drop,
                                                        tmp_path):
    path = tmp_path / f"{backbone}.pth"
    encoder_file(backbone, path, drop=drop)
    model = build_model(port_cfg("fpn", backbone=backbone))
    with pytest.raises(KeyError, match=drop.replace(".", r"\.")):
        load_pretrained_encoder(model, str(path))
    with pytest.raises(KeyError):
        jax_encoder_after_load(backbone, path)


def test_a_file_of_another_family_raises(tmp_path):
    path = tmp_path / "mnv2.npz"
    encoder_file("mobilenet_v2", path)
    model = build_model(port_cfg("fpn", backbone="efficientnet-b0"))
    with pytest.raises(KeyError, match="does not fit"):
        load_pretrained_encoder(model, str(path))


# -- the trainer -------------------------------------------------------------

@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("pretrained_data")
    for split, n, seed in (("train", 8, 0), ("val", 4, 1)):
        generate_synthetic_patches(str(root / split), n=n, size=SIZE,
                                   seed=seed)
    return root


def _trainer(data_root, save, **kw):
    cfg = Config(img_size=SIZE, compute_dtype="float32", batch_size=4,
                 seed=5, **kw)
    ds = PatchDataset(*discover_split(str(data_root / "train")), cfg)
    return Trainer(cfg, str(save), ds, ds, device="cpu")


def test_trainer_loads_the_file_and_a_resume_overrides_it(data_root,
                                                          tmp_path, capsys):
    """DeepLabV3+/mobilenet_v2 with ``pretrained_path``: the encoder holds
    the file's weights before the first step, the decoder the seed's; the
    trainer of a rerun loads the file again, and its resume then puts
    ``latest.pth``'s weights in their place."""
    path = tmp_path / "mnv2.pth"
    want = encoder_file("mobilenet_v2", path, seed=7)
    kw = dict(model="deeplabv3+", backbone="mobilenet_v2",
              pretrained_path=str(path))
    first = _trainer(data_root, tmp_path / "out", epochs=1, **kw)
    assert "random init" not in capsys.readouterr().out
    for k, v in first.model.encoder.state_dict().items():
        assert torch.equal(v, want[k]), k
    plain = _trainer(data_root, tmp_path / "plain", epochs=1,
                     model="deeplabv3+", backbone="mobilenet_v2")
    assert "encoder starts from random init" in capsys.readouterr().out
    dec = "decoder.block1.0.weight"
    assert torch.equal(first.model.state_dict()[dec],
                       plain.model.state_dict()[dec])
    first.train()
    trained = load_reference_state_dict(str(tmp_path / "out" / "pth" /
                                             "latest.pth"))
    again = _trainer(data_root, tmp_path / "out", epochs=2, **kw)
    for k, v in again.model.encoder.state_dict().items():
        assert torch.equal(v, want[k]), k
    start, _ = again._resume()
    assert start == 1
    moved = 0
    for k, v in again.model.state_dict().items():
        assert torch.equal(v, trained[k]), k
        moved += k.startswith("encoder.") and not torch.equal(
            v, want[k[len("encoder."):]])
    assert moved > 0


def test_resunet_trainer_loads_a_resnet18_npz(data_root, tmp_path):
    """ResUNet (resnet18 whatever ``backbone`` says) takes the converted
    torchvision ``.npz``."""
    path = tmp_path / "resnet18.npz"
    want = encoder_file("resnet18", path, seed=9)
    trainer = _trainer(data_root, tmp_path / "out", model="unet",
                       backbone="efficientnet-b0", pretrained_path=str(path))
    for k, v in trainer.model.encoder.state_dict().items():
        assert torch.equal(v, want[k]), k


@pytest.mark.parametrize("model_name,backbone", [
    ("deeplabv3+", "mobilenet_v2"), ("fpn", "efficientnet-b0")])
def test_cli_train_from_a_pretrained_file_then_resumes(model_name, backbone,
                                                       tmp_path, capsys):
    """``cli.train --device cpu`` on the new backbones with
    ``pretrained_path`` (bf16, 64²): two finite epochs, then the resume."""
    path = tmp_path / f"{backbone}.npz"
    encoder_file(backbone, path, seed=11)
    assert_cli_train_and_resume(model_name, tmp_path, capsys,
                                backbone=backbone, pretrained_path=str(path))
