"""The gather probe's counterpart (renderer_rs_tpu_torch/probes/kgather.py)
against the JAX probe's five bodies (probes/probe_kgather.py:58-61 t_only,
:67-70 g_only, :76-82 g8, :88-95 g50, :105-112 msum). The script itself
cannot be imported (it runs at import and writes a compilation cache), so
its bodies stand here twice: transcribed to numpy, and copied as jnp code
run through jax.lax.fori_loop as the Pallas kernel's loop runs them
(:29-36). Bar: bit-equal at iters = 8; every body sums exact f32 terms in
one fixed order (msum's masked sum has one nonzero term)."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ITERS = 8


def _numpy_body(body, slab, p, iters):
    acc = np.zeros((16, 128), np.float32)
    for j in range(iters):
        s = slab + np.float32(j) * np.float32(1e-12)
        if body == "t_only":
            acc = acc + s.T[:16]
        elif body == "g_only":
            acc = acc + s[0][p]
        elif body in ("g8", "g50"):
            for k in range(8 if body == "g8" else 50):
                acc = acc + s[p, k]
        else:
            acc = acc + np.sum(s[:, 0, None, None] * (np.arange(128)[:, None, None] == p[None]),
                               axis=0, dtype=np.float32)
    return acc


def _jax_body(body, slab, p, iters):
    """The probe's bodies as it writes them (probe_kgather.py:58-112), run
    through fori_loop from a zero [16,128] sum."""
    import jax
    import jax.numpy as jnp

    sub_h, tw, ch = 16, 128, 128

    def t_only(slab, p, acc, j):
        s = slab + j.astype(jnp.float32) * 1e-12
        sT = jnp.swapaxes(s, 0, 1)
        return acc + sT[0:sub_h, :]

    def g_only(slab, p, acc, j):
        row = slab[0:1, :] + j.astype(jnp.float32) * 1e-12
        xk = jnp.broadcast_to(row, (sub_h, tw))
        return acc + jnp.take_along_axis(xk, p, axis=1)

    def gk(n):
        def g(slab, p, acc, j):
            s = slab + j.astype(jnp.float32) * 1e-12
            sT = jnp.swapaxes(s, 0, 1)
            for k in range(n):
                xk = jnp.broadcast_to(sT[k:k + 1, :], (sub_h, tw))
                acc = acc + jnp.take_along_axis(xk, p, axis=1)
            return acc
        return g

    def msum(slab, p, acc, j):
        s = slab + j.astype(jnp.float32) * 1e-12
        uf = (jax.lax.broadcasted_iota(jnp.int32, (ch, sub_h, tw), 0)
              == p[None]).astype(jnp.float32)
        col = s[:, 0:1].reshape(ch, 1, 1)
        return acc + jnp.sum(col * uf, axis=0)

    fn = {"t_only": t_only, "g_only": g_only, "g8": gk(8), "g50": gk(50), "msum": msum}[body]
    slab_j, p_j = jnp.asarray(slab), jnp.asarray(p)
    return np.asarray(jax.lax.fori_loop(0, iters, lambda j, acc: fn(slab_j, p_j, acc, j),
                                        jnp.zeros((sub_h, tw), jnp.float32)))


@pytest.mark.parametrize("body", ["t_only", "g_only", "g8", "g50", "msum"])
def test_plain_probe_matches_the_jax_bodies(body):
    from renderer_rs_tpu_torch.probes.kgather import kgather, probe_inputs, run_plain

    slab, p = probe_inputs("cpu")
    got = run_plain(body, slab, p, ITERS).numpy()
    ref = _numpy_body(body, slab.numpy(), p.numpy(), ITERS)
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))
    assert np.array_equal(got.view(np.uint32), _jax_body(body, slab.numpy(), p.numpy(),
                                                         ITERS).view(np.uint32))
    before = kgather.launches
    assert torch.equal(kgather(body, slab, p, ITERS), torch.from_numpy(got))
    assert kgather.launches == before  # CPU tensors: the plain version


def test_probe_wrapper_rejects_bad_inputs():
    from renderer_rs_tpu_torch.probes.kgather import kgather, probe_inputs

    slab, p = probe_inputs("cpu")
    with pytest.raises(ValueError, match="unknown body"):
        kgather("g3", slab, p, 1)
    with pytest.raises(ValueError, match="int32"):
        kgather("g8", slab, p.long(), 1)
    with pytest.raises(ValueError, match="128,128"):
        kgather("g8", slab[:64].contiguous(), p, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("body", ["t_only", "g_only", "g8", "g50", "msum"])
def test_cuda_probe_matches_plain(body):
    """On the card: the kernel against its plain version at 64 iterations,
    bit-equal. Needs no JAX; run it where the card is with `python -m pytest
    --noconftest -m cuda tests/test_torch_probe.py`."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from renderer_rs_tpu_torch.probes.kgather import kgather, probe_inputs, run_plain

    slab, p = probe_inputs("cuda")
    before = kgather.launches
    out = kgather(body, slab, p, 64)
    torch.cuda.synchronize()
    assert kgather.launches == before + 1
    assert torch.equal(out.view(torch.int32), run_plain(body, slab, p, 64).view(torch.int32))
