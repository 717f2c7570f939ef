"""The plain models (models/cnn.py, models/lenet.py) under the chunk's
``torch.func.vmap``: stacked parameters turn their convolutions into grouped
ones and their dense layers into batched matmuls, and flax's bf16 policy
(each convolution rounded to bf16, its bias added as its own bf16 op) is
kept. Held against per-model calls, and a chunked run of the headline's
``TpuCifarCNN`` and of ``LeNet5`` against the JAX package's at the same
chunk and the port's at chunk 1.

Tolerances: f32 models, logits and gradients at rtol 1e-4 / atol 1e-4 of
the leaf's largest magnitude (tests/test_torch_cnn.py's f32 bound: grouped
and plain convolutions sum in other orders); bf16 CNNs, logits within
2**-7 of the largest logit (one bf16 ulp) and gradients within a relative
L2 of 2**-6 (tests/test_torch_cnn.py's bf16 bounds); runs, test losses at
rtol 1e-4 (tests/test_torch_batched_rounds.py's f32 bound).

Every test here runs with functorch's per-example fallback disabled.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from distributed_learning_simulator_tpu_torch.models import registry
from distributed_learning_simulator_tpu_torch.parallel.engine import (
    no_vmap_fallback,
)
from test_torch_batched_rounds import _three_runs
from torch_runs import losses_of


@pytest.fixture(autouse=True)
def _strict_vmap():
    with no_vmap_fallback():
        yield


@pytest.mark.parametrize("name,shape,args", [
    ("mlp", (8, 8, 1), {}),
    ("lenet5", (28, 28, 1), {}),
    ("cnn", (32, 32, 3), {"dtype": "float32"}),
    ("cnn_tpu", (32, 32, 3), {"dtype": "float32", "width": 32}),
    ("cnn", (32, 32, 3), {}),
    ("cnn_tpu", (32, 32, 3), {"width": 32}),
])
def test_plain_models_vmap_match_per_model_calls(name, shape, args):
    model = registry.get_model(name, input_shape=shape, **args)
    gen = torch.Generator().manual_seed(3)
    m = 3
    params = {k: torch.stack([v.detach() + 0.05 * torch.randn(
        v.shape, generator=gen) for _ in range(m)])
        for k, v in model.named_parameters()}
    x = torch.rand((m, 5) + shape, generator=gen)
    y = torch.randint(0, 10, (m, 5), generator=gen)

    def loss(p, xx, yy):
        logits = torch.func.functional_call(model, p, (xx,))
        return F.cross_entropy(logits, yy), logits

    grads, (_, logits) = torch.func.vmap(
        torch.func.grad_and_value(loss, has_aux=True))(params, x, y)
    bf16 = "dtype" not in args and name != "mlp" and name != "lenet5"
    for i in range(m):
        p_i = {k: v[i] for k, v in params.items()}
        g_i, (_, l_i) = torch.func.grad_and_value(loss, has_aux=True)(
            p_i, x[i], y[i])
        top = l_i.abs().max().item()
        if bf16:
            assert (logits[i] - l_i).abs().max().item() <= 2.0**-7 * top
        else:
            torch.testing.assert_close(logits[i], l_i, rtol=1e-4,
                                       atol=1e-4 * top)
        for k, g in g_i.items():
            got = grads[k][i].float()
            if bf16:
                rel = ((got - g.float()).norm()
                       / g.float().norm().clamp(min=1e-12)).item()
                assert rel <= 2.0**-6, k
            else:
                torch.testing.assert_close(
                    got, g, rtol=1e-4, atol=1e-4 * g.abs().max().item())


@pytest.mark.parametrize("model_name,shape,args", [
    ("cnn_tpu", (8, 8, 3), {"width": 16, "dtype": "float32"}),
    ("lenet5", (28, 28, 1), {}),
])
def test_plain_model_chunked_run_matches_jax(model_name, shape, args):
    jres, pres, ores, _, _ = _three_runs(
        model_name=model_name, model_args=args,
        dataset_args={"shape": shape}, client_chunk_size=3,
        bucket_client_work=False)
    for other in (jres, ores):
        np.testing.assert_allclose(losses_of(pres), losses_of(other),
                                   rtol=1e-4)
