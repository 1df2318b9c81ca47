"""The port's int8 serving path (``infer/quantized.py``) against the JAX
package's, on the CPU (the int8 convolutions through their plain version),
for ResUNet, FPN, DeepLabV3+ (default and non-default rates) and PSPNet on
resnet18.

Setup, the JAX ``tests/test_quantized.py``'s: each model's flax init from
``PRNGKey(0)``, carried into the port's names, and four uint8 64² images
from ``default_rng(7)``.  Per model:

* the float mirror against the port model's own infer step at rtol 1e-4,
  atol 1e-5 (the JAX test's bounds);
* calibrated activation scales against the JAX ``calibrate`` at a
  relative 1e-5, over the same sites;
* on the JAX bundle carried across (``quantized_bundle_from_jax``): the
  stem's int8 input and int32 sums bitwise, and the port's int8 masks
  ≥ 99.5% equal to the JAX int8 path's (largest |Δprob| printed).  The
  JAX forward runs here one operation at a time (``jax.disable_jit``):
  jitted, XLA contracts the epilogue's ``y·a + b`` into FMAs and turns
  the division by a constant scale into a multiply by its reciprocal, while
  the port (and its kernel) rounds each multiply, add and divide, as the
  JAX source writes them.  The jitted JAX path's agreement is printed
  beside it;
* the JAX package's gates against the float mirror, under both
  ``act_storage`` modes: masks > 98% equal and mean |Δprob| < 0.05.  One
  exception, FPN with bf16 storage: on this init 5% of the float
  probabilities lie within 0.01 of 0.5 and the JAX package's own int8 path
  agrees on 97.7% of mask pixels, so there the port must agree at least as
  well as the JAX path does (less 0.5%), and its mean |Δprob| < 0.05.

Then ResUNet's skip-scale invariant, int8 sliding-window and banded runs,
the artifact-free refusals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdac_pathological_image_segmentation_tpu.config import Config as JaxConfig
from pdac_pathological_image_segmentation_tpu.infer import (
    quantized as jq,
)
from pdac_pathological_image_segmentation_tpu.models import (
    build_model as jax_build_model,
)
from pdac_pathological_image_segmentation_tpu.train.state import (
    create_train_state,
)
from pdac_pathological_image_segmentation_tpu_torch import Config
from pdac_pathological_image_segmentation_tpu_torch.infer import quantized as q
from pdac_pathological_image_segmentation_tpu_torch.infer.wsi import (
    BandedSlidingWindow,
    GridTiler,
    SlidingWindowInference,
)
from pdac_pathological_image_segmentation_tpu_torch.models import build_model
from pdac_pathological_image_segmentation_tpu_torch.ops.int8_conv import (
    int8_conv,
    quantize_activation,
)
from pdac_pathological_image_segmentation_tpu_torch.train.steps import (
    make_infer_step,
)
from pdac_pathological_image_segmentation_tpu_torch.utils import (
    torch_weights as tw,
)

SIZE = 64
IMAGES = np.random.default_rng(7).integers(0, 256, (4, SIZE, SIZE, 3),
                                           dtype=np.uint8)
# name -> (model, config extras)
CASES = {
    "unet": ("unet", {}),
    "fpn": ("fpn", {}),
    "deeplabv3+": ("deeplabv3+", {}),
    "deeplabv3+_rates_6_12_18": ("deeplabv3+", {"dilations": (6, 12, 18)}),
    "pspnet": ("pspnet", {}),
}
FROM_JAX = {"unet": tw.resunet_state_dict_from_jax,
            "fpn": tw.fpn_state_dict_from_jax,
            "deeplabv3+": tw.deeplabv3plus_state_dict_from_jax,
            "pspnet": tw.pspnet_state_dict_from_jax}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class _Case:
    """Both sides of one model: the JAX state, bundle and forward; the port
    model, ``state_dict``, bundle and forward."""

    def __init__(self, name):
        model_name, extras = CASES[name]
        jcfg = JaxConfig(model=model_name, img_size=SIZE,
                         compute_dtype="float32", **extras)
        state = create_train_state(jcfg, jax_build_model(jcfg),
                                   jax.random.PRNGKey(0))
        self.params = state.params
        self.bstats = state.batch_stats
        self.jbundle, self.jforward = jq.quantize_from_config(
            jcfg, self.params, self.bstats, [jnp.asarray(IMAGES)])
        np_tree = jax.tree_util.tree_map(np.asarray, (self.params,
                                                      self.bstats))
        self.cfg = Config(model=model_name, img_size=SIZE,
                          compute_dtype="float32", **extras)
        self.model = build_model(self.cfg)
        self.model.load_state_dict(FROM_JAX[model_name](*np_tree),
                                   strict=True)
        self.sd = self.model.state_dict()
        self.bundle, self.forward = q.quantize_from_config(self.cfg, self.sd,
                                                           [IMAGES])
        self.fprob = q.make_float_infer_step(self.sd, SIZE,
                                             self.forward)(IMAGES)

    def jax_int8(self, act_storage="int8"):
        return np.asarray(jq.make_quantized_infer_step(
            self.params, self.bstats, self.jbundle, SIZE,
            forward=self.jforward, act_storage=act_storage)(
                jnp.asarray(IMAGES)))


_CACHE: dict = {}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    if request.param not in _CACHE:
        _CACHE[request.param] = _Case(request.param)
    return _CACHE[request.param]


def test_float_mirror_matches_port_model(case):
    ref = make_infer_step(case.model, SIZE)(torch.from_numpy(IMAGES))
    np.testing.assert_allclose(case.fprob.numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_calibrated_scales_match_jax(case):
    got, want = case.bundle["act_scales"], case.jbundle["act_scales"]
    assert set(got) == set(want)
    assert set(case.bundle["qweights"]) == set(case.jbundle["qweights"])
    for site in want:
        assert got[site] == pytest.approx(float(want[site]), rel=1e-5), site


def test_carried_bundle_stem_bitwise(case):
    """The stem's int8 input and its int32 sums equal the JAX ones."""
    carried = tw.quantized_bundle_from_jax(case.jbundle)
    s = float(np.float32(carried["act_scales"]["stem"]))
    x = q._normalize(torch.from_numpy(IMAGES))
    xq = quantize_activation(x, s)
    jxq = jnp.clip(jnp.round(jnp.asarray(x.numpy()) / jnp.float32(s)), -127,
                   127).astype(jnp.int8)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    kq, ks = carried["qweights"]["stem"]
    got = int8_conv(xq.contiguous(), s, kq, ks, 2, 3, 1,
                    out_dtype=torch.int32)
    want = jax.lax.conv_general_dilated(
        jxq, case.jbundle["qweights"]["stem"][0], (2, 2), ((3, 3), (3, 3)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_port_int8_matches_jax_int8_on_carried_bundle(case):
    carried = tw.quantized_bundle_from_jax(case.jbundle)
    got = q.make_quantized_infer_step(case.sd, carried, SIZE,
                                      case.forward)(IMAGES).numpy()
    with jax.disable_jit():
        want = case.jax_int8()
    agree = np.mean((got >= 0.5) == (want >= 0.5))
    err = float(np.abs(got - want).max())
    jitted = case.jax_int8()
    print(f"{case.cfg.model} {case.cfg.dilations}: port vs JAX int8 masks "
          f"{agree:.6f}, largest |dprob| {err:.3g}; vs the jitted JAX path "
          f"{np.mean((got >= 0.5) == (jitted >= 0.5)):.6f}, "
          f"{float(np.abs(got - jitted).max()):.3g}")
    assert agree >= 0.995, (agree, err)


@pytest.mark.parametrize("act_storage", ["int8", "bf16"])
def test_int8_gates_against_float_mirror(case, act_storage):
    qprob = q.make_quantized_infer_step(case.sd, case.bundle, SIZE,
                                        case.forward,
                                        act_storage=act_storage)(IMAGES)
    fprob = case.fprob
    mae = float((qprob - fprob).abs().mean())
    agree = float(((qprob >= 0.5) == (fprob >= 0.5)).float().mean())
    assert mae < 0.05, mae
    if case.cfg.model == "fpn" and act_storage == "bf16":
        jf = np.asarray(jq.make_float_infer_step(
            case.params, case.bstats, SIZE, forward=case.jforward)(
                jnp.asarray(IMAGES)))
        jagree = float(np.mean((case.jax_int8("bf16") >= 0.5)
                               == (jf >= 0.5)))
        assert agree >= jagree - 0.005, (agree, jagree)
    else:
        assert agree > 0.98, agree


def test_skip_scale_invariant():
    """A stage output is quantized once with its next stage's scale and
    read by the decoder's skip half too: both record the same tensor's
    amax (the JAX ``test_int8_storage_skip_scale_invariant``)."""
    c = _CACHE.get("unet") or _CACHE.setdefault("unet", _Case("unet"))
    s = c.bundle["act_scales"]
    assert s["layer2_0.conv1"] == pytest.approx(s["dec3.b"])
    assert s["layer3_0.conv1"] == pytest.approx(s["dec2.b"])
    assert s["layer4_0.conv1"] == pytest.approx(s["dec1.b"])
    assert s["layer2_0.conv1"] == pytest.approx(s["layer2_0.ds"])


def test_int8_sliding_window_and_banded():
    """The int8 step in the runners' ``infer_step`` slot (``cli.overlay
    --int8``): masks > 98% equal to the float model's run, and the banded
    runner equal to the plain one within float16."""
    c = _CACHE.get("unet") or _CACHE.setdefault("unet", _Case("unet"))
    slide = np.concatenate([IMAGES[0], IMAGES[1]], axis=1)  # 64 x 128
    source = GridTiler(slide, tile=SIZE, stride=SIZE // 2)
    qstep = q.make_quantized_infer_step(c.sd, c.bundle, SIZE, c.forward)
    common = dict(tile=SIZE, batch_size=2, blend="uniform", num_workers=1,
                  device="cpu")
    ref, _ = SlidingWindowInference(c.model, **common).run(source)
    got, mask = SlidingWindowInference(None, infer_step=qstep,
                                       **common).run(source)
    assert np.mean((got >= 0.5) == (ref >= 0.5)) > 0.98
    band, bmask = BandedSlidingWindow(None, infer_step=qstep, band_h=SIZE,
                                      **common).run(source)
    np.testing.assert_allclose(band.astype(np.float32), got, atol=1e-3)
    assert np.mean(bmask == mask) > 0.999


def test_refusals():
    sd = {"w": torch.zeros(1)}
    with pytest.raises(ValueError, match="no int8 path for model 'unet\\+\\+'"):
        q.quantize_model("unet++", sd, [IMAGES], SIZE)
    with pytest.raises(ValueError, match="resnet18"):
        q.quantize_model("fpn", sd, [IMAGES], SIZE, backbone="mobilenet_v2")
    with pytest.raises(ValueError, match="stain"):
        q.make_forward("fpn", stain="vahadane")
    with pytest.raises(ValueError, match="act_storage"):
        q.make_quantized_infer_step(sd, {"act_scales": {}, "qweights": {}},
                                    SIZE, act_storage="fp8")
