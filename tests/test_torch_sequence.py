"""Sequence parallelism of the port (``parallel/sequence.py``) over gloo
ranks against the JAX package's ``parallel/sequence.py`` on its virtual
CPU devices.

One group of four spawned ranks (``torch_dist_scenarios``, no JAX) runs
every multi-rank case: ``ppermute`` (a wrapping ring and a non-wrapping
chain) and ``all_to_all``, forward and gradients, on the 4-rank line of
a (4,) ``("sequence",)`` mesh and on the 2-rank ``sequence`` lines of a
(2, 2) ``("data", "sequence")`` mesh; ``halo_exchange``;
``sequence_sharded_scan`` forward and reverse (with the block's and the
parameters' gradients) on both meshes; ``ring_attention`` causal and
not.  The JAX side runs ``shard_map`` over as many virtual devices.
Tolerances: exchanges and the halo EQUAL (they move data), the scans
1e-5 (``tests/test_sequence_rnn.py``), ring attention 2e-5 and its
gradients 5e-4 (``tests/test_sequence.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import torch_dist_scenarios as sc
from analytics_zoo_tpu.parallel import create_mesh
from analytics_zoo_tpu.parallel import sequence as jseq
from analytics_zoo_tpu_torch.parallel import sequence as seq

WORLD = 4
ATTN_TOL, ATTN_GRAD_TOL = 2e-5, 5e-4
SCAN_TOL = 1e-5
rng = np.random.RandomState(0)


def _blocks(n, seed):
    r = np.random.RandomState(seed)
    x = r.randn(n, 2 * n, 3).astype(np.float32)
    cot = {k: r.randn(*shape).astype(np.float32) for k, shape in
           (("ring", (n, 2 * n, 3)), ("chain", (n, 2 * n, 3)),
            ("a2a", (n, 2, 3 * n)))}
    return x, cot


SCAN = dict(x=rng.randn(4, 32, 6).astype(np.float32),
            kernel=(rng.randn(6, 6) * 0.3).astype(np.float32),
            bias=(rng.randn(6) * 0.1).astype(np.float32),
            cot=rng.randn(4, 32, 6).astype(np.float32))
QKV = [(rng.randn(2, 32, 4, 8) * 0.5).astype(np.float32) for _ in range(3)]
ATTN_COT = rng.randn(2, 32, 4, 8).astype(np.float32)
HALO_X = rng.randn(1, 32, 3).astype(np.float32)


@pytest.fixture(scope="module")
def ranks():
    x4, c4 = _blocks(4, 1)
    x2, c2 = _blocks(2, 2)
    one, two = ((4,), ("sequence",)), ((2, 2), ("data", "sequence"))
    scenarios = {
        "ex4": ("seq_exchanges", dict(x=x4, cot=c4, shape=one[0],
                                      axes=one[1])),
        "ex2": ("seq_exchanges", dict(x=x2, cot=c2, shape=two[0],
                                      axes=two[1])),
        "halo": ("seq_halo", dict(x=HALO_X, shape=one[0], axes=one[1],
                                  left=2, right=3)),
        "scan1": ("seq_scan", dict(**SCAN, shape=one[0], axes=one[1])),
        "scan2": ("seq_scan", dict(**SCAN, shape=two[0], axes=two[1],
                                   batch_axis="data")),
    }
    for causal in (False, True):
        scenarios[f"ring{causal}"] = ("seq_ring", dict(
            q=QKV[0], k=QKV[1], v=QKV[2], cot=ATTN_COT, shape=one[0],
            axes=one[1], causal=causal))
    return sc.spawn_async(WORLD, scenarios)


def _jax_mesh(shape, axes):
    return create_mesh(shape, axis_names=axes,
                       devices=jax.devices()[:int(np.prod(shape))])


def _jax_exchanges(x, cot, n):
    """Each exchange of the JAX package on n devices: (out, grad) per
    device, indexed like the ranks' ``idx``."""
    mesh = _jax_mesh((n,), ("s",))
    ops = {"ring": lambda t: jax.lax.ppermute(
               t, "s", [(i, (i + 1) % n) for i in range(n)]),
           "chain": lambda t: jax.lax.ppermute(
               t, "s", [(i, i + 1) for i in range(n - 1)]),
           "a2a": lambda t: jax.lax.all_to_all(t, "s", 0, 1, tiled=True)}
    out = {}
    for name, op in ops.items():
        f = jseq._shard_map(lambda b, op=op: op(b[0])[None], mesh,
                            in_specs=(JP("s"),), out_specs=JP("s"))
        y = f(jnp.asarray(x))
        g = jax.grad(lambda a, f=f, c=jnp.asarray(cot[name]):
                     jnp.sum(f(a) * c))(jnp.asarray(x))
        out[name] = (np.asarray(y), np.asarray(g))
    return out


@pytest.mark.parametrize("width", [2, 4])
def test_ppermute_and_all_to_all_match_jax(ranks, width):
    """``ppermute`` over a wrapping ring and a non-wrapping chain (the
    rank that receives nothing gets zeros) and the tiled ``all_to_all``,
    on a 4-rank line and on 2-rank lines: every rank's output and its
    input's gradient EQUAL to ``lax.ppermute``/``lax.all_to_all``'s."""
    x, cot = _blocks(width, 1 if width == 4 else 2)
    want = _jax_exchanges(x, cot, width)
    for r in ranks.result()[:WORLD]:
        got = r[f"ex{width}"]
        for name, (y, g) in want.items():
            np.testing.assert_array_equal(got[name][0], y[got["idx"]],
                                          err_msg=name)
            np.testing.assert_array_equal(got[name][1], g[got["idx"]],
                                          err_msg=name)


def test_halo_exchange_matches_reference(ranks):
    """A block extended by 2 frames of its left neighbour and 3 of its
    right one, zeros at the ends: EQUAL to the reference's
    ``halo_exchange`` on a (4,) mesh."""
    mesh = _jax_mesh((4,), ("sequence",))
    f = jseq._shard_map(lambda b: jseq.halo_exchange(b, "sequence", 2, 3),
                        mesh, in_specs=(JP(None, "sequence", None),),
                        out_specs=JP(None, "sequence", None))
    want = np.asarray(f(jnp.asarray(HALO_X))).reshape(1, 4, 13, 3)
    for r in ranks.result():
        got = r["halo"]
        np.testing.assert_array_equal(got["ext"], want[:, got["idx"]])


def _jax_scan(reverse, x, kernel, bias, cot):
    """The plain scan of the reference tests' step: output and the
    gradients of ``sum(out · cot)``."""
    def run(x, k, b):
        eye = jnp.eye(x.shape[-1], k.shape[0])

        def step(h, x_t):
            y = jnp.tanh(x_t @ eye + h @ k + b)
            return y, y

        xs = jnp.flip(x, 1) if reverse else x
        _, ys = jax.lax.scan(step, jnp.zeros((x.shape[0], k.shape[0])),
                             jnp.moveaxis(xs, 1, 0))
        ys = jnp.moveaxis(ys, 0, 1)
        return jnp.flip(ys, 1) if reverse else ys

    args = tuple(jnp.asarray(a) for a in (x, kernel, bias))
    out = run(*args)
    grads = jax.grad(lambda *a: jnp.sum(run(*a) * cot), (0, 1, 2))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("mesh", ["1d", "2d"])
def test_sequence_sharded_scan_matches_reference(ranks, reverse, mesh):
    """The n-round pipelined scan on a (4,) sequence mesh and on a (2, 2)
    data × sequence mesh: each rank's block within 1e-5 of the
    reference's ``sequence_sharded_scan`` on the same mesh; the block's
    gradient and the parameters' (summed over the sequence ranks)
    within 1e-5 of JAX's gradients of the plain scan."""
    shape, axes, batch_axis = (((4,), ("sequence",), None) if mesh == "1d"
                               else ((2, 2), ("data", "sequence"), "data"))
    jm = _jax_mesh(shape, axes)
    k, b = jnp.asarray(SCAN["kernel"]), jnp.asarray(SCAN["bias"])

    def step(h, x_t):
        y = jnp.tanh(x_t @ jnp.eye(x_t.shape[-1], k.shape[0]) + h @ k + b)
        return y, y

    want = np.asarray(jseq.sequence_sharded_scan(
        step, jnp.zeros((4, 6)), jnp.asarray(SCAN["x"]), jm,
        reverse=reverse, batch_axis=batch_axis))
    plain, (gx, gk, gb) = _jax_scan(reverse, SCAN["x"], SCAN["kernel"],
                                    SCAN["bias"], SCAN["cot"])
    np.testing.assert_allclose(want, plain, rtol=SCAN_TOL, atol=SCAN_TOL)
    n_seq = shape[-1]
    tb = 32 // n_seq
    for r in ranks.result():
        got = r[f"scan{1 if mesh == '1d' else 2}"]
        start, per = got["rows"]
        t = slice(got["idx"] * tb, (got["idx"] + 1) * tb)
        rows = slice(start, start + per)
        ys, g_x, g_k, g_b = got[reverse]
        np.testing.assert_allclose(ys, want[rows, t], rtol=SCAN_TOL,
                                   atol=SCAN_TOL)
        np.testing.assert_allclose(g_x, gx[rows, t], rtol=SCAN_TOL,
                                   atol=SCAN_TOL)
        if batch_axis is None:
            np.testing.assert_allclose(g_k, gk, rtol=SCAN_TOL, atol=SCAN_TOL)
            np.testing.assert_allclose(g_b, gb, rtol=SCAN_TOL, atol=SCAN_TOL)


@functools.lru_cache(maxsize=None)
def _jax_attention(causal):
    q, k, v = (jnp.asarray(a) for a in QKV)
    jm = _jax_mesh((4,), ("sequence",))
    ring = jseq.ring_attention(*(jseq.shard_sequence(a, jm)
                                 for a in (q, k, v)), jm, causal=causal)
    full = jseq.full_attention(q, k, v, causal=causal)
    grads = jax.grad(lambda *a: jnp.sum(
        jseq.full_attention(*a, causal=causal) * ATTN_COT),
        (0, 1, 2))(q, k, v)
    return np.asarray(ring), np.asarray(full), [np.asarray(g)
                                                for g in grads]


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_reference(ranks, causal):
    """The online-softmax ring over 4 ranks (causal masking by the
    blocks' global offsets): each output block within 2e-5 of the
    reference's ``ring_attention`` and ``full_attention``; the q/k/v
    blocks' gradients within 5e-4 of the full attention's."""
    ring, full, grads = _jax_attention(causal)
    for r in ranks.result():
        got = r[f"ring{causal}"]
        t = slice(got["idx"] * 8, (got["idx"] + 1) * 8)
        for want in (ring, full):
            np.testing.assert_allclose(got["out"], want[:, t],
                                       rtol=ATTN_TOL, atol=ATTN_TOL)
        for g, w in zip(got["grads"], grads):
            np.testing.assert_allclose(g, w[:, t], rtol=ATTN_GRAD_TOL,
                                       atol=ATTN_GRAD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_full_attention_matches_reference(causal):
    """``full_attention`` in one process against the reference's, and a
    one-rank ``RingAttentionLayer`` (no sequence axis) is it."""
    q, k, v = (torch.from_numpy(a) for a in QKV)
    want = np.asarray(jseq.full_attention(*(jnp.asarray(a) for a in QKV),
                                          causal=causal))
    got = seq.full_attention(q, k, v, causal=causal).numpy()
    np.testing.assert_allclose(got, want, rtol=ATTN_TOL, atol=ATTN_TOL)
    layer = seq.RingAttentionLayer(sc.StubMesh({"sequence": 1}),
                                   causal=causal)
    np.testing.assert_array_equal(layer(q, k, v).numpy(), got)


def test_shard_sequence_and_one_rank_exchanges():
    """``shard_sequence`` keeps the rank's T-block (host arrays and
    tensors alike) and refuses a T the axis does not divide; on a
    one-rank group an exchange is the identity and a receive from
    nobody is zeros."""
    mesh = sc.StubMesh({"data": 1, "sequence": 2})
    x = np.arange(24, dtype=np.float32).reshape(2, 6, 2)
    np.testing.assert_array_equal(seq.shard_sequence(x, mesh), x[:, :3])
    np.testing.assert_array_equal(
        seq.shard_sequence(torch.from_numpy(x), mesh).numpy(), x[:, :3])
    with pytest.raises(ValueError, match="not divisible"):
        seq.shard_sequence(x[:, :5], mesh)
    t = torch.ones(3)
    assert torch.equal(seq.ppermute(t, None, [(0, 0)]), t)
    assert torch.equal(seq.ppermute(t, None, []), torch.zeros(3))
    assert torch.equal(seq.unshard_sequence(t), t)
