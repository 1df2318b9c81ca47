"""What the existing configurations read, pinned bit for bit: seeded
weights, FLOP counts, convolution sites, the reference's losses on small
train batches (in float32 and as the fp8 control), and the program's
``Config``.

The values were read at commit 39c212a4e0dbb1e4c9d1722d463a809113d43844,
before configurations could name their reference module; a change to how
the references are reached must leave every one of them as it is."""

from __future__ import annotations

import hashlib

import pytest
import torch

from benchmark import harness
from benchmark.counts import flops
from benchmark.reference import models, quant
from benchmark.reference import train as ref_train
from benchmark.tests.conftest import configs, small_cell

SEED = 2 ** 31 + 77
PINNED = {
    "fpn_r18": {
        "weights": "36b3b22ce76d213dd0ee0de249277c31"
                   "39591a535887512bdb5840a79f31d04e",
        "forward_flops": 35513171968,
        "train_flops": 105306390528,
        "sites": 32,
        "sites_digest": "5a9f29537acc4cc44c0b7b0b938b4773"
                        "f00ad0d853072ea8960c0324a480d6de",
        "losses": {
            "float32": [0.964188814163208, 0.7265475988388062,
                        0.6609535217285156],
            "fp8_step": [0.9597951769828796, 0.7302091717720032,
                         0.6419950723648071]},
    },
    "resunet_r18": {
        "weights": "398f73a6feb1eaf8ca3f4f1d994903d0"
                   "bd243cc4a062550751e84ac05ce6a1d1",
        "forward_flops": 27005026304,
        "train_flops": 79781953536,
        "sites": 24,
        "sites_digest": "6c954520b418a2de5cb3d9d6fc581a58"
                        "f21bec10b52cab94c53cd217054b4bea",
        "losses": {
            "float32": [0.964327871799469, 0.7534415125846863,
                        0.705777645111084],
            "fp8_step": [0.9645259380340576, 0.757294774055481,
                         0.7060187458992004]},
    },
}
NAMES = list(PINNED)


@pytest.fixture
def one_thread():
    """One CPU thread: float32 sums then come out in one order on any
    machine (four threads read 1 ulp apart on some losses)."""
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(4)


@pytest.mark.parametrize("name", NAMES)
def test_seeded_weights(name):
    h = hashlib.sha256()
    for k, t in harness.weights(configs()[name], SEED, "cpu").items():
        h.update(f"{k}{tuple(t.shape)}{t.dtype}".encode())
        h.update(t.contiguous().numpy().tobytes())
    assert h.hexdigest() == PINNED[name]["weights"]


@pytest.mark.parametrize("name", NAMES)
def test_flops_and_conv_sites(name):
    cfg, want = configs()[name], PINNED[name]
    assert flops.forward_flops(cfg, 512) == want["forward_flops"]
    assert flops.train_flops(cfg, 512) == want["train_flops"]
    sites = flops.conv_sites(cfg, 512)
    assert len(sites) == want["sites"]
    assert hashlib.sha256(repr(sites).encode()).hexdigest() \
        == want["sites_digest"]


@pytest.mark.parametrize("name", NAMES)
def test_reference_losses_on_small_batches(one_thread, name):
    """The float32 reference and the fp8 control (operands and the
    ``stored`` outputs rounded) over the small train cell's checked
    batches, drawn as the driver's feed draws them."""
    cell = small_cell(f"{name}.train_b128", SEED)
    drv = harness.driver(cell.traffic)
    tr, cfg, dev = cell.traffic, cell.config, torch.device("cpu")
    sd = harness.weights(cfg, SEED, dev)
    images, masks = drv.make_patches(tr, SEED, dev)
    feed = drv.Feed(tr, SEED, dev, images.shape[0])
    batches = drv.checked_batches(images, masks, [
        feed.next() for _ in range(tr["check_steps"])])
    for side, q in (("float32", None), ("fp8_step", quant.fp8_step)):
        model = harness.reference_model(cfg, sd, dev)
        models.set_quantizer(model, q, outputs=True)
        got = ref_train.run_steps(model, cfg, batches)["losses"]
        assert got == PINNED[name]["losses"][side], side


@pytest.mark.parametrize("name", NAMES)
def test_program_config_is_the_fixed_keys_config(name):
    """Every key that names a field of the program's ``Config`` gives, for
    these files, the ``Config`` of the eight keys handed over before."""
    from pdac_pathological_image_segmentation_tpu_torch import Config

    cfg = configs()[name]
    before = Config.from_dict({k: cfg[k] for k in (
        "model", "backbone", "img_size", "compute_dtype", "num_classes",
        "batch_size", "lr", "loss")})
    assert harness.program_config(cfg).to_dict() == before.to_dict()


def test_program_config_passes_dilations():
    cfg = dict(configs()["fpn_r18"], model="deeplabv3+", dilations=[2, 4, 6],
               seed=5)
    got = harness.program_config(cfg)
    assert got.dilations == (2, 4, 6) and got.seed == 5
    assert got.model == "deeplabv3+" and got.extras == {"loss": "dice"}
