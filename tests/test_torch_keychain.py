"""The key chain end to end: ``run_simulation`` of the port and of the JAX
package from the same initial parameters, with NO injected draws, so every
batch order, rounding salt and quantization salt comes from the port's own
replay of the JAX key chain (ops/prng.py).

* ``fed`` with bf16 local state at lr 0: each client's model is its
  stochastically rounded broadcast, a function of its rounding salt alone,
  so the global model after each round equals the JAX package's up to the
  f32 aggregation order (rtol 1e-5) and the test losses agree at rtol
  1e-5. A salt off by one bit moves about half the coordinates by a bf16
  ulp, which this bound catches.
* ``fed`` with bf16 local state at lr 0.05: per-round test losses within
  rtol 2e-3. Stochastic rounding hashes the f32 value's bits, so an
  ulp-level difference between the two packages' f32 gradients redraws
  that coordinate's rounding: a run drifts by bf16 ulps (2**-8 relative)
  on the coordinates that differ, not by 1e-4. The same run in f32 agrees
  at rtol 1e-4, the injected parity tests' tolerance.
* ``fed_quant`` (f32 local state, 256 levels): the dither hashes the
  value's bits, so an ulp-level difference redraws an element's rounding
  and the two models differ by quantization levels, as in
  tests/test_torch_fed_quant.py. After one round the global model is
  within half a level of the JAX package's on average, and within three
  levels per coordinate: one broadcast level plus one weighted upload
  level, where a client's upload range (before averaging) may exceed the
  final model's, on whose range the level is measured here. Test losses
  within rtol 5e-3.
"""

import numpy as np
import pytest
import torch

from distributed_learning_simulator_tpu_torch.models.bridge import (
    jax_leaf_order,
)
from distributed_learning_simulator_tpu_torch.models.registry import (
    get_model,
)
from distributed_learning_simulator_tpu_torch.ops.quantize import (
    Segments,
    stochastic_quantize,
)
from torch_runs import BASE, HW, flat_params, losses_of, run_both


def _names_and_numels():
    model = get_model("resnet18", **BASE["model_args"])
    names = jax_leaf_order(model, (HW, HW))
    shapes = dict(model.named_parameters())
    return names, [shapes[n].numel() for n in names]


def test_bf16_salts_replay_jax_at_lr0():
    jres, pres = run_both(local_compute_dtype="bfloat16",
                          learning_rate=0.0)
    names, _ = _names_and_numels()
    want = flat_params(jres, names)
    got = flat_params(pres, names)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(losses_of(pres), losses_of(jres), rtol=1e-5)


@pytest.mark.parametrize("dtype,rtol", [("bfloat16", 2e-3),
                                        ("float32", 1e-4)])
def test_fed_run_matches_jax(dtype, rtol):
    jres, pres = run_both(local_compute_dtype=dtype)
    np.testing.assert_allclose(losses_of(pres), losses_of(jres), rtol=rtol)


def test_fed_quant_run_matches_jax():
    jres, pres = run_both(distributed_algorithm="fed_quant",
                          quant_levels=256, round=1)
    names, numels = _names_and_numels()
    want = flat_params(jres, names)
    got = flat_params(pres, names)
    seg = Segments(numels)
    # The broadcast's level per leaf (the affine scale of the final model).
    level = seg.spread(stochastic_quantize(want, 256, [0] * len(numels),
                                           seg).scale)
    diff = (got - want).abs()
    assert (diff <= 3 * level).all()
    assert (diff / level).mean().item() < 0.5
    np.testing.assert_allclose(losses_of(pres), losses_of(jres), rtol=5e-3)


# The payload salts of every fed_quant path, recorded from the JAX round
# program itself (run eagerly, so its hooks see concrete keys) on a linear
# model, against the salts the port's round hands its hooks.
SALT_CASES = {
    # client_eval: the materializing path, one split over the cohort.
    "materializing": dict(client_eval=True),
    # Sizes [7, 12, 11, 10, 12] at batch 4 and chunk 2: a 3-step group of
    # four clients (two chunks, its key split three ways) and a 2-step one.
    "bucketed": dict(client_eval=False),
    # No schedule: chunks of 2 over 5 clients, a remainder chunk.
    "plain_chunks": dict(client_eval=False, bucket_client_work=False),
    # Partial participation: the cohort's positions, chunked.
    "sampled": dict(client_eval=False, participation_fraction=0.6),
}


@pytest.mark.parametrize("case", sorted(SALT_CASES))
def test_fed_quant_payload_salts_follow_the_jax_chain(case):
    import jax
    import jax.numpy as jnp

    from distributed_learning_simulator_tpu.algorithms.fed_quant import (
        FedQuant as JaxFedQuant,
    )
    from distributed_learning_simulator_tpu.config import (
        ExperimentConfig as JaxConfig,
    )
    from distributed_learning_simulator_tpu.parallel import engine as jengine
    from distributed_learning_simulator_tpu_torch.algorithms.fed_quant import (
        FedQuant,
    )
    from distributed_learning_simulator_tpu_torch.config import (
        ExperimentConfig,
    )
    from distributed_learning_simulator_tpu_torch.data.registry import (
        get_dataset,
    )
    from distributed_learning_simulator_tpu_torch.models.registry import (
        ParamLayout,
    )
    from distributed_learning_simulator_tpu_torch.ops import prng
    from distributed_learning_simulator_tpu_torch.parallel import engine
    from distributed_learning_simulator_tpu_torch.simulator import (
        build_client_data,
    )

    kw = dict(
        distributed_algorithm="fed_quant", worker_number=5, seed=4, epoch=1,
        batch_size=4, learning_rate=0.05, partition="dirichlet",
        dirichlet_alpha=0.3, max_shard_size=12, client_chunk_size=2,
        **SALT_CASES[case],
    )
    ds = get_dataset("synthetic", n_train=60, n_test=8, seed=4,
                     shape=(2, 2, 3))
    cfg = ExperimentConfig(device="cpu", **kw)
    cd = build_client_data(cfg, ds)
    rng = np.random.default_rng(0)
    params = {"b": rng.normal(size=10).astype(np.float32),
              "w": rng.normal(size=(12, 10)).astype(np.float32)}
    round_key = jax.random.key(5)

    def salts_of(key_data, n):
        return [prng.leaf_salts(k, 2) for k in prng.split(key_data, n)]

    jalgo = JaxFedQuant(JaxConfig(**kw))
    want = []
    j_upload, j_down = jalgo.process_client_payload, jalgo.process_aggregated

    # The hooks run inside the jitted round; ordered callbacks hand their
    # keys to the host in program order.
    def j_record_upload(stack, key):
        n = jax.tree_util.tree_leaves(stack)[0].shape[0]
        jax.debug.callback(
            lambda kd: want.extend(salts_of(np.asarray(kd), n)),
            jax.random.key_data(key), ordered=True)
        return j_upload(stack, key)

    def j_record_down(global_params, key):
        jax.debug.callback(
            lambda kd: want.append(prng.leaf_salts(np.asarray(kd), 2)),
            jax.random.key_data(key), ordered=True)
        return j_down(global_params, key)

    jalgo.process_client_payload = j_record_upload
    jalgo.process_aggregated = j_record_down

    def japply(variables, x):
        p = variables["params"]
        return x.reshape(x.shape[0], -1) @ p["w"] + p["b"]

    jalgo.prepare(japply, jengine.make_eval_fn(japply))
    jround = jalgo.make_round_fn(
        japply, jengine.make_optimizer("sgd", 0.05), cd.n_clients,
        preprocess=jengine.make_decoder(cd.sample_shape),
        client_sizes=cd.sizes,
    )
    jax.block_until_ready(jax.jit(jround)(
        {k: jnp.asarray(v) for k, v in params.items()}, None,
        jnp.asarray(cd.x), jnp.asarray(cd.y), jnp.asarray(cd.mask),
        jnp.asarray(cd.sizes), round_key))
    jax.effects_barrier()

    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    layout = ParamLayout.from_params(tparams, ["b", "w"])

    def apply(views, x):
        return x.reshape(x.shape[0], -1) @ views["w"] + views["b"]

    algo = FedQuant(cfg)
    got = []
    upload, down = algo.process_client_payload, algo.process_aggregated

    def record_upload(chunk, salts):
        # The hook takes a chunk's uploads with one salt list per member.
        got.extend(list(s) for s in salts)
        return upload(chunk, salts)

    def record_down(flat, salts):
        got.append(list(salts))
        return down(flat, salts)

    algo.process_client_payload = record_upload
    algo.process_aggregated = record_down
    xb, yb, mb = engine.pad_eval_set(ds.x_test, ds.y_test, 8)
    algo.prepare(apply, engine.make_eval_fn(apply), (
        torch.from_numpy(xb), torch.from_numpy(yb.astype(np.int64)),
        torch.from_numpy(mb)))
    round_fn = algo.make_round_fn(
        apply, engine.make_optimizer("sgd", 0.05), layout, cd.n_clients,
        preprocess=engine.make_decoder(cd.sample_shape),
        client_sizes=cd.sizes, device="cpu",
    )
    round_fn(layout.flatten(tparams), None, torch.from_numpy(cd.x),
             torch.from_numpy(cd.y.astype(np.int64)),
             torch.from_numpy(cd.mask), cd.sizes,
             np.asarray(jax.random.key_data(round_key)))
    # Uploads in reduction order, then the broadcast.
    assert got == want
    assert len(got) == cfg.cohort_size() + 1


def test_sign_sgd_run_matches_jax():
    # Per-epoch, per-client permutations from the round key; the vote is
    # exact given equal gradients (tests/test_torch_sign_sgd.py).
    jres, pres = run_both(distributed_algorithm="sign_SGD",
                          learning_rate=0.001)
    np.testing.assert_allclose(losses_of(pres), losses_of(jres), rtol=1e-4)
