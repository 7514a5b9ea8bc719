"""The port's DDPG agent and replay ring against the JAX package.

``update_chunk`` is fed the replay indices the JAX chunk draws (recomputed
from its key as ``device_replay_sample`` draws them: randomness is fed,
not matched). Tolerances: every ``AgentState`` leaf ≤1e-5 after the
chunk (the bound the JAX package holds its own update paths to); ring
contents exact; host acting bit-exact (the same numpy code and
generator on the same weights).
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import ddpg as J  # noqa: E402
from repro.core.replay import DeviceReplay as JReplay  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import ddpg as T  # noqa: E402
from repro_torch.core.replay import DeviceReplay as TReplay  # noqa: E402

S, A, B = 33, 3, 16


def _cfgs(**kw):
    base = dict(state_dim=S, action_dim=A, hidden=(32, 24), batch_size=B)
    base.update(kw)
    return J.DDPGConfig(**base), T.DDPGConfig(**base)


def _transitions(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, S)).astype(np.float32),
            rng.random((n, A)).astype(np.float32),
            rng.standard_normal(n).astype(np.float32),
            rng.standard_normal((n, S)).astype(np.float32),
            (rng.random(n) < 0.1).astype(np.float32))


def _assert_state_close(t, j, atol):
    j = jax.device_get(j)
    for name in ("actor", "critic", "target_actor", "target_critic"):
        for jl, tl in zip(getattr(j, name), getattr(t, name)):
            for k in jl:
                np.testing.assert_allclose(tl[k].numpy(), jl[k], atol=atol,
                                           err_msg=f"{name}.{k}")
    for name in ("opt_a", "opt_c"):
        jo, to = getattr(j, name), getattr(t, name)
        assert to["t"] == int(jo["t"])
        for mom in ("m", "v"):
            for jl, tl in zip(jo[mom], to[mom]):
                for k in jl:
                    np.testing.assert_allclose(tl[k].numpy(), jl[k],
                                               atol=atol)
    for name in ("norm_mean", "norm_var", "reward_ma", "reward_ma_init"):
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   getattr(j, name), atol=atol)


@pytest.mark.parametrize("n,ma_init", [(1, False), (4, False), (3, True)])
def test_update_chunk_matches_jax_with_fed_indices(n, ma_init):
    jcfg, tcfg = _cfgs()
    st = J.agent_init(jcfg, jax.random.PRNGKey(n))
    rng = np.random.default_rng(n)
    st = st._replace(
        norm_mean=jax.numpy.asarray(rng.standard_normal(S), np.float32),
        norm_var=jax.numpy.asarray(rng.random(S) + 0.5, np.float32),
        reward_ma=jax.numpy.asarray(0.3 if ma_init else 0.0, np.float32),
        reward_ma_init=jax.numpy.asarray(float(ma_init), np.float32))
    jr, tr = JReplay(100, S, A), TReplay(100, S, A, device="cpu")
    for part in (_transitions(40, 1), _transitions(30, 2)):
        jr.push_batch(*part)
        tr.push_batch(*part)
    j_new, (jlc, jla) = J._update_chunk_jit(jcfg, st, jr.data, n)
    _, keys = J.chunk_sample_keys(st.key, n)
    idx = np.stack([np.asarray(jax.random.randint(k, (B,), 0, len(jr)))
                    for k in keys])
    t_new, (tlc, tla) = T.update_chunk(
        tcfg, convert.agent_state(jax.device_get(st), device="cpu"), tr, n,
        indices=torch.as_tensor(idx))
    _assert_state_close(t_new, j_new, atol=1e-5)
    np.testing.assert_allclose(tlc.numpy(), np.asarray(jlc), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tla.numpy(), np.asarray(jla), rtol=1e-5,
                               atol=1e-5)


def test_replay_ring_matches_jax():
    jr, tr = JReplay(50, S, A), TReplay(50, S, A, device="cpu")
    for n, seed in ((20, 0), (45, 1), (70, 2), (3, 3)):   # wraps, oversize
        part = _transitions(n, seed)
        jr.push_batch(*part)
        tr.push_batch(*part)
        assert (tr.ptr, tr.size) == (jr.ptr, jr.size)
        for a, b in zip((tr.states, tr.actions, tr.rewards, tr.next_states,
                         tr.dones), jr.data[:5]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    idx = torch.tensor([0, 7, 49, 7])
    got = tr.sample(4, idx=idx)
    np.testing.assert_array_equal(got[0].numpy(),
                                  np.asarray(jr.data.states)[idx.numpy()])


def test_replay_sampling_is_uniform_over_filled_prefix():
    """The port's own generator: a distribution test only."""
    tr = TReplay(100, S, A, device="cpu")
    tr.push_batch(*_transitions(40, 0))
    gen = torch.Generator().manual_seed(0)
    idx = torch.cat([tr.sample_indices(B, gen) for _ in range(500)])
    assert int(idx.min()) == 0 and int(idx.max()) == 39
    counts = torch.bincount(idx, minlength=40).float()
    expected = idx.numel() / 40
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 80.0          # 39 dof: p ~ 1e-4 beyond this


def test_agent_acting_matches_jax():
    """Same weights and seed: warmup draws, actor means and truncated-
    normal exploration all match bit for bit."""
    jcfg, tcfg = _cfgs()
    ja, ta = J.DDPGAgent(jcfg, seed=5), T.DDPGAgent(tcfg, seed=5,
                                                  device="cpu")
    ta.state = convert.agent_state(jax.device_get(ja.state), device="cpu")
    states = np.random.default_rng(1).standard_normal((12, S)).astype(
        np.float32)
    ja.observe_states(states[:6])
    ta.observe_states(states[:6])
    np.testing.assert_array_equal(ta.norm.mean, ja.norm.mean)
    np.testing.assert_array_equal(ta.norm.var, ja.norm.var)
    for i, s in enumerate(states):
        sigma = (0.0, 0.5, 3.0)[i % 3]        # 3.0: the clipped fallback
        np.testing.assert_array_equal(
            ta.act(s, sigma, random=i < 3), ja.act(s, sigma, random=i < 3))
    for e in (0, 3, 10, 25):
        assert ta.sigma_at(e) == ja.sigma_at(e)


def test_agent_init_shapes_and_final_layer_scale():
    tcfg = _cfgs()[1]
    st = T.agent_init(tcfg, torch.Generator().manual_seed(0), "cpu")
    dims = [(S, 32), (32, 24), (24, A)]
    assert [tuple(l["w"].shape) for l in st.actor] == dims
    assert [tuple(l["w"].shape) for l in st.critic] == \
        [(S + A, 32), (32, 24), (24, 1)]
    assert float(st.actor[2]["w"].abs().max()) <= 3e-3
    assert float(st.actor[0]["w"].abs().max()) <= 1 / np.sqrt(S)
    for t, o in zip(st.target_actor, st.actor):
        assert torch.equal(t["w"], o["w"]) and t["w"] is not o["w"]


def test_trunk_runs_through_k2_or_raises():
    """Actor and critic always take K2's wrapper: a CPU tensor gets its
    plain version, any other device launches or is refused, and a net
    that is not the 3-layer trunk is refused rather than run plainly."""
    st = T.agent_init(_cfgs()[1], torch.Generator().manual_seed(0), "cpu")
    meta = [{k: v.to("meta") for k, v in l.items()} for l in st.actor]
    with pytest.raises(ValueError, match="CUDA"):
        T.actor_forward(meta, torch.empty((4, S), device="meta"))
    with pytest.raises(ValueError, match="3 layers"):
        T.actor_forward(st.actor[:2], torch.zeros((4, S)))


def test_ddpg_step_targets_equal_the_per_network_update_exactly():
    """``ddpg_step`` updates both target networks in one K3 call over all
    12 leaves; on the CPU the targets it returns equal, bit for bit, the
    update of each network as one flat buffer (the path before the
    single launch: concatenate, ``polyak_ref``, split)."""
    from repro_torch.kernels.ref import polyak_ref
    tcfg = _cfgs()[1]
    st = T.agent_init(tcfg, torch.Generator().manual_seed(3), "cpu")
    # targets that differ from the online networks
    ta = [{k: v + 0.01 for k, v in l.items()} for l in st.target_actor]
    tc = [{k: v - 0.02 for k, v in l.items()} for l in st.target_critic]
    s, a, r, s2, done = (torch.from_numpy(x[:B]) for x in _transitions(B, 4))
    actor, critic, t_actor, t_critic, *_ = T.ddpg_step(
        tcfg, st.actor, st.critic, ta, tc, st.opt_a, st.opt_c,
        (s, a, r, s2, done))
    for got, target, online in ((t_actor, ta, actor),
                                (t_critic, tc, critic)):
        keys = [(i, k) for i, l in enumerate(target) for k in sorted(l)]
        flat = polyak_ref(
            torch.cat([target[i][k].reshape(-1) for i, k in keys]),
            torch.cat([online[i][k].reshape(-1) for i, k in keys]),
            tcfg.tau)
        off = 0
        for i, k in keys:
            n = target[i][k].numel()
            assert torch.equal(got[i][k],
                               flat[off:off + n].view(target[i][k].shape))
            off += n
