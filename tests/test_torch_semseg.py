"""Port's ResNet-50 dilated FCN vs the Flax model at reduced depth
(stage_sizes=(1,1,1,1)) on a 64x128 image, with the Flax weights carried
over by name (onnx_port.export_named_tensors -> load_named_tensors).

Tolerance: logits within 2e-3 max abs (both float32 on the CPU; the
remaining difference is convolution summation order), argmax parity at
least 99.8%.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pc_accumulation_lib_tpu.models import onnx_port
from pc_accumulation_lib_tpu.models.resnet_semseg import (
    ResNet50DilatedFCN as FlaxFCN)
from pc_accumulation_lib_tpu.models.resnet_semseg import init_params
from pc_accumulation_lib_tpu_torch.models.resnet_semseg import (
    ResNet50DilatedFCN)
from pc_accumulation_lib_tpu_torch.models.semseg import (SemSegTorch,
                                                          load_named_tensors)

STAGES = (1, 1, 1, 1)


@pytest.fixture(scope='module')
def flax_model_and_named():
    model = FlaxFCN(dtype=jnp.float32, stage_sizes=STAGES)
    variables = init_params(model, jax.random.PRNGKey(0))
    named = onnx_port.export_named_tensors(variables)
    # Non-trivial batch-norm statistics, so every tensor's mapping matters.
    rng = np.random.default_rng(1)
    for k in named:
        if k.endswith('running_mean') or k.endswith('.bias'):
            named[k] = rng.normal(0, 0.1, named[k].shape).astype(np.float32)
        elif (k.endswith('running_var')
              or (k.endswith('.weight') and named[k].ndim == 1)):
            named[k] = rng.uniform(0.5, 1.5, named[k].shape).astype(
                np.float32)
    variables = onnx_port.convert_named_tensors(named, model=model,
                                                variables=variables)
    return model, variables, named


def test_logits_match_flax(flax_model_and_named):
    model, variables, named = flax_model_and_named
    img = np.random.default_rng(2).integers(0, 256, size=(1, 64, 128, 3))
    want = np.asarray(model.apply(variables, jnp.asarray(img, jnp.float32),
                                  train=False))
    net = ResNet50DilatedFCN(stage_sizes=STAGES).eval()
    load_named_tensors(net, named)
    with torch.no_grad():
        got = net(torch.from_numpy(img.astype(np.float32))).numpy()
    assert got.shape == want.shape == (1, 64, 128, 19)
    np.testing.assert_allclose(got, want, atol=2e-3)
    assert np.mean(got.argmax(-1) == want.argmax(-1)) >= 0.998


def test_semseg_wrapper_predicts_class_map(flax_model_and_named):
    _, _, named = flax_model_and_named
    sem = SemSegTorch('cpu', stage_sizes=STAGES)
    load_named_tensors(sem, named)
    img = np.random.default_rng(3).integers(0, 256, size=(64, 128, 3),
                                            dtype=np.uint8)
    out = sem(img)
    assert out.shape == (64, 128) and out.dtype == np.int32
    assert out.min() >= 0 and out.max() < 19


def test_load_named_tensors_is_strict(flax_model_and_named):
    _, _, named = flax_model_and_named
    net = ResNet50DilatedFCN(stage_sizes=STAGES)
    bad = dict(named)
    del bad['decode_head.conv_seg.bias']
    with pytest.raises(KeyError, match='conv_seg.bias'):
        load_named_tensors(net, bad)
    bad = dict(named, extra=np.zeros(1, np.float32))
    with pytest.raises(KeyError, match='extra'):
        load_named_tensors(net, bad)
