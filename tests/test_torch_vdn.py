"""The port's VDN trainer (``purejaxql_torch/algo/pqn_vdn.py``) on the CPU
against the JAX package: masked epsilon-greedy against
``get_greedy_actions`` and by its statistics, the dueling head against
flax's and its checkpoint, the agents-folded forward against the vmap over
agents, the VDN targets through the closure-form returns against the JAX
recursion, one grad step (flax-form, FAST_BPTT, FAST_BPTT with the GRU scan's
twins) against the JAX math of pqn_vdn.py:287-385, the launch plans at the
five configs' shapes, tiny trainer runs, the cuda policy, the options that
raise and the CLI recipe.

Sizes are tiny (T 9, 3 agents x 4 envs, H 32); no JAX trainer is compiled."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from purejaxql_torch import cli
from purejaxql_torch.algo import exploration, pqn_vdn
from purejaxql_torch.algo.types import MARLTransition
from purejaxql_torch.core import checkpoint as tckpt
from purejaxql_torch.core.config import compose
from purejaxql_torch.core.optim import make_optimizer
from purejaxql_torch.envs.marl import make_marl
from purejaxql_torch.models.rnn import RNNQNetwork as TRNNQNetwork
from purejaxql_torch.ops import gru_scan as tgs
from purejaxql_torch.ops import lambda_returns as tlr
from purejaxql_torch.utils.logging import MemorySink, MetricLogger
from purejaxql_tpu.algo.pqn_vdn import get_greedy_actions
from purejaxql_tpu.core import checkpoint as jckpt
from purejaxql_tpu.core.optim import make_optimizer as jax_make_optimizer
from purejaxql_tpu.models.rnn import RNNQNetwork as JRNNQNetwork

torch.set_num_threads(1)

T, A, B, D, N_ACT, H = 9, 3, 4, 7, 5, 32


def tiny_vdn_config(alg="pqn_vdn_spread", **kw):
    return compose(
        alg=alg,
        overrides=[
            "DEVICE=cpu", "TOTAL_TIMESTEPS=768", "NUM_ENVS=8", "NUM_STEPS=8", "MEMORY_WINDOW=2",
            "NUM_MINIBATCHES=2", "NUM_EPOCHS=2", "HIDDEN_SIZE=32", "TEST_DURING_TRAINING=False",
        ] + [f"{k}={v}" for k, v in kw.items()],
    )


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jnet(dueling=False):
    return JRNNQNetwork(action_dim=N_ACT, hidden_size=H, num_layers=2, num_rnn_layers=1, cell_type="gru",
                        norm_input=False, norm_type="layer_norm", add_last_action=False, dueling=dueling)


def _variables(jnet, seed=3):
    """flax variables, the running statistics moved off their init."""
    variables = jnet.init(jax.random.PRNGKey(seed), jnet.initialize_carry(1), jnp.zeros((1, 1, D)),
                          jnp.zeros((1, 1)), jnp.zeros((1, 1), jnp.int32), train=False)
    return {**variables, "batch_stats": jax.tree_util.tree_map(lambda v: v + 0.25, variables["batch_stats"])}


def _tnet(variables, dueling=False):
    tnet = TRNNQNetwork(D, N_ACT, hidden_size=H, num_layers=2, dueling=dueling)
    tnet.load_state_dict(tckpt.params_from_flax(_np(variables)))
    return tnet


def _masks(rng, shape):
    """0/1 legal-action masks with at least one legal action a row."""
    avail = (rng.rand(*shape) < 0.5).astype(np.float32)
    rows = avail.reshape(-1, shape[-1])
    rows[rows.sum(1) == 0, rng.randint(shape[-1])] = 1.0
    return avail


# ---- masked epsilon-greedy ---------------------------------------------------------


def test_masked_greedy_matches_jax_with_nan_rows():
    """eps 0: the greedy legal action of `get_greedy_actions` on the same Q
    and masks, a NaN in some rows (legal and illegal: the first NaN wins)
    and ties."""
    rng = np.random.RandomState(0)
    q = rng.randn(3, 64, 6).astype(np.float32)
    avail = _masks(rng, (3, 64, 6))
    q[0, :8, 2] = np.nan
    q[1, :8, [1, 4]] = np.nan
    q[2, :8] = 1.0  # ties: the first legal action
    want = np.asarray(get_greedy_actions(jnp.asarray(q), jnp.asarray(avail)))
    got = exploration.masked_eps_greedy(torch.Generator().manual_seed(0), torch.tensor(q), 0.0, torch.tensor(avail))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(exploration.greedy_legal_actions(torch.tensor(q), torch.tensor(avail)).numpy(), want)


def test_masked_random_branch_is_uniform_over_legal_actions():
    """eps 1: never an illegal action, each legal one with frequency 1 /
    n_legal (chi-square over 20k rows of one mask), and P(random) = eps."""
    gen = torch.Generator().manual_seed(1)
    mask = torch.tensor([1.0, 0.0, 1.0, 1.0, 0.0, 1.0, 1.0])
    n = 20_000
    q = torch.randn(n, 7, generator=gen)
    acts = exploration.masked_eps_greedy(gen, q, 1.0, mask.expand(n, -1))
    assert mask[acts].all()
    counts = torch.bincount(acts, minlength=7)[mask.bool()].double()
    expected = n / 5
    chi2 = ((counts - expected) ** 2 / expected).sum().item()
    assert chi2 < 18.5, (counts, chi2)  # p = 0.001 at 4 degrees of freedom
    rng = np.random.RandomState(2)
    avail = torch.tensor(_masks(rng, (n, 7)))
    acts = exploration.masked_eps_greedy(gen, q, 1.0, avail)
    assert avail.gather(1, acts[:, None]).all()
    # P(random) = eps: a random action leaves the unique greedy one w.p. (n_legal - 1) / n_legal
    full = torch.ones(n, 7)
    greedy = q.argmax(1)
    for eps in (0.1, 0.5):
        acts = exploration.masked_eps_greedy(gen, q, eps, full)
        assert abs((acts != greedy).double().mean().item() - eps * 6 / 7) < 0.012


# ---- the network: dueling head, checkpoint, agents folded into rows ---------------


def _net_inputs(seed, t=T, rows=A * B):
    rng = np.random.RandomState(seed)
    return (rng.randn(t, rows, D).astype(np.float32), (rng.rand(t, rows) < 0.2).astype(np.float32),
            np.zeros((t, rows), np.int32), [0.3 * rng.randn(rows, H).astype(np.float32)])


def test_dueling_head_matches_flax_and_crosses_both_ways(tmp_path):
    """RNNQNetwork(dueling=True) from flax's weights: Q and the new hidden
    state within 1e-5 of flax's in eval and train mode; the port's file loads
    in the JAX loader with flax's tree (value Dense_2 (H, 1), advantage
    Dense_3) and back."""
    jnet = _jnet(dueling=True)
    variables = _variables(jnet)
    tnet = _tnet(variables, dueling=True)
    x, done, la, hs = _net_inputs(1)
    for train in (False, True):
        out = jnet.apply(variables, [jnp.asarray(h) for h in hs], jnp.asarray(x), jnp.asarray(done), jnp.asarray(la),
                         train=train, mutable=["batch_stats"] if train else False)
        jh, jq = out[0] if train else out
        with torch.set_grad_enabled(train):
            th, tq = tnet([torch.tensor(h) for h in hs], torch.tensor(x), torch.tensor(done), torch.tensor(la),
                          train=train)
        np.testing.assert_allclose(tq.detach().numpy(), np.asarray(jq), atol=1e-5, rtol=0)
        np.testing.assert_allclose(th[0].detach().numpy(), np.asarray(jh[0]), atol=1e-5, rtol=0)
    fresh = TRNNQNetwork(D, N_ACT, hidden_size=H, num_layers=2, dueling=True,
                         generator=torch.Generator().manual_seed(4))
    path = str(tmp_path / "dueling.safetensors")
    tckpt.save_params(tckpt.params_to_flax(fresh)["params"], path)
    loaded = jckpt.load_params(path)
    shapes = lambda t: jax.tree_util.tree_map(lambda v: tuple(np.shape(v)), t)  # noqa: E731
    assert shapes(loaded) == shapes(variables["params"])
    assert tuple(loaded["Dense_2"]["kernel"].shape) == (H, 1) and tuple(loaded["Dense_3"]["kernel"].shape) == (H, N_ACT)
    _, jq = jnet.apply({"params": jax.tree_util.tree_map(jnp.asarray, loaded), "batch_stats": variables["batch_stats"]},
                       [jnp.asarray(h) for h in hs], jnp.asarray(x), jnp.asarray(done), jnp.asarray(la), train=False)
    back = TRNNQNetwork(D, N_ACT, hidden_size=H, num_layers=2, dueling=True)
    back.load_state_dict(tckpt.params_from_flax({"params": tckpt.load_params(path),
                                                  "batch_stats": _np(variables["batch_stats"])}))
    with torch.no_grad():
        _, tq = back([torch.tensor(h) for h in hs], torch.tensor(x), torch.tensor(done), torch.tensor(la), train=False)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-5, rtol=0)


def test_agents_folded_forward_matches_the_vmap_over_agents():
    """One eval-mode step of every agent as one forward over the A x E rows
    gives the JAX trainer's vmap of the network over the agent axis
    (pqn_vdn.py:177-195), Q and hidden within 1e-5."""
    jnet = _jnet()
    variables = _variables(jnet)
    tnet = _tnet(variables)
    rng = np.random.RandomState(5)
    obs = rng.randn(A, B, D).astype(np.float32)
    done = (rng.rand(A, B) < 0.3).astype(np.float32)
    hs = 0.3 * rng.randn(A, B, H).astype(np.float32)

    def one_agent(h, o, d):
        new_h, q = jnet.apply(variables, [h], o[None], d[None], jnp.zeros((1, B), jnp.int32), train=False)
        return new_h[0], q[0]

    jh, jq = jax.vmap(one_agent)(jnp.asarray(hs), jnp.asarray(obs), jnp.asarray(done))
    with torch.no_grad():
        th, tq = pqn_vdn.agents_forward(tnet, [torch.tensor(hs)], torch.tensor(obs), torch.tensor(done))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-5, rtol=0)
    np.testing.assert_allclose(th[0].numpy(), np.asarray(jh), atol=1e-5, rtol=0)


# ---- targets and one grad step --------------------------------------------------------


def jax_vdn_targets(last_q, q_vals, reward, done, gamma, lam):
    """pqn_vdn.py:287-315, `_compute_targets`, as the JAX trainer runs it."""
    def _get_target(carry, rew_q_done):
        reward, q, done = rew_q_done
        lam_ret, next_q = carry
        target_bootstrap = reward + gamma * (1 - done) * next_q
        delta = lam_ret - next_q
        lam_ret = target_bootstrap + gamma * lam * delta
        lam_ret = (1 - done) * lam_ret + done * reward
        next_q = jnp.max(q, axis=-1).sum(axis=0)
        return (lam_ret, next_q), lam_ret

    lam_ret = reward[-1] + gamma * (1 - done[-1]) * last_q
    last_q = jnp.max(q_vals[-1], axis=-1).sum(axis=0)
    _, targets = jax.lax.scan(_get_target, (lam_ret, last_q),
                              jax.tree_util.tree_map(lambda x: x[:-1], (reward, q_vals, done)), reverse=True)
    return jnp.concatenate([targets, lam_ret[np.newaxis]])


def _window(seed=0, masks_matter=True):
    """A numpy-seeded minibatch (T, A, B): obs, legal actions under masks
    that hide the largest Q of many rows, team rewards and dones."""
    rng = np.random.RandomState(seed)
    avail = _masks(rng, (T, A, B, N_ACT))
    action = np.array([rng.choice(np.flatnonzero(row)) for row in avail.reshape(-1, N_ACT)]).reshape(T, A, B)
    return dict(
        obs=rng.randn(T, A, B, D).astype(np.float32), action=action.astype(np.int64),
        reward=rng.randn(T, 1, B).astype(np.float32), done=(rng.rand(T, 1, B) < 0.25).astype(np.float32),
        last_hs=(0.3 * rng.randn(T, A, B, H).astype(np.float32),),
        last_done=(rng.rand(T, A, B) < 0.2).astype(np.float32), avail_actions=avail,
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_vdn_targets_match_the_jax_recursion(seed):
    """`vdn_targets` (the closure-form wrapper, the twin on the CPU) against
    `_compute_targets` on the same masked Q-values, illegal actions holding
    the largest Q of many rows: within 1e-5."""
    rng = np.random.RandomState(seed)
    q = rng.randn(T, A, B, N_ACT).astype(np.float32)
    avail = _masks(rng, (T, A, B, N_ACT))
    q = np.where(avail > 0, q, q + 3.0).astype(np.float32)  # the masks decide the maxima
    rew, done = rng.randn(T, B).astype(np.float32), (rng.rand(T, B) < 0.3).astype(np.float32)
    valid = jnp.asarray(q) - (1 - jnp.asarray(avail)) * 1e10
    want = jax_vdn_targets(valid[-1].max(-1).sum(0), valid[:-1], jnp.asarray(rew)[:-1], jnp.asarray(done)[:-1],
                           0.99, 0.85)
    before = tlr.lambda_returns_closure.launches
    got = pqn_vdn.vdn_targets(torch.tensor(q), torch.tensor(avail), torch.tensor(rew), torch.tensor(done), 0.99, 0.85)
    assert tlr.lambda_returns_closure.launches == before  # the twin, on the CPU
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-6)


@pytest.fixture(scope="module")
def jax_vdn_step():
    """Two grad steps on one window by the JAX math of pqn_vdn.py:287-394
    (the flax-form forward, `_compute_targets`, the MSE, clip + RAdam under
    VDN's LR schedule: 3 grad steps to 1e-10): the config, the variables,
    the window, both losses, the new params and batch_stats."""
    config = tiny_vdn_config(TOTAL_TIMESTEPS=300, NUM_ENVS=4, NUM_STEPS=25, NUM_MINIBATCHES=1, NUM_EPOCHS=1)
    config["NUM_UPDATES"] = 3
    jnet = _jnet()
    variables = _variables(jnet)
    w = {k: (tuple(jnp.asarray(x) for x in v) if isinstance(v, tuple) else jnp.asarray(v))
         for k, v in _window().items()}
    gamma, lam = config["GAMMA"], config["LAMBDA"]

    def loss_fn(params, batch_stats):
        hs0 = [w["last_hs"][0][0].reshape(-1, H)]
        obs = w["obs"].reshape(T, -1, D)
        ld = w["last_done"].reshape(T, -1)
        (_, q), updates = jnet.apply({"params": params, "batch_stats": batch_stats}, hs0, obs, ld,
                                     jnp.zeros(ld.shape, jnp.int32), train=True, mutable=["batch_stats"])
        q = q.reshape(T, A, -1, N_ACT)
        valid_q = jax.lax.stop_gradient(q) - (1 - w["avail_actions"]) * 1e10
        target = jax_vdn_targets(valid_q[-1].max(-1).sum(0), valid_q[:-1], w["reward"][:-1, 0], w["done"][:-1, 0],
                                 gamma, lam).reshape(-1)
        chosen = jnp.take_along_axis(q, w["action"][..., None], -1).squeeze(-1)
        loss = jnp.mean((chosen.sum(1)[:-1].reshape(-1) - jax.lax.stop_gradient(target)) ** 2)
        return loss, updates["batch_stats"]

    lr = optax.linear_schedule(config["LR"], 1e-10, config["NUM_EPOCHS"] * config["NUM_MINIBATCHES"] * 3)
    tx = jax_make_optimizer(config["MAX_GRAD_NORM"], lr)

    @jax.jit
    def learn(params, batch_stats, opt_state):
        (loss, bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(params, batch_stats)
        updates, opt_state = tx.update(grads, opt_state, params)
        return loss, optax.apply_updates(params, updates), bs, opt_state

    params, bs, opt_state = variables["params"], variables["batch_stats"], tx.init(variables["params"])
    losses = []
    for _ in range(2):
        loss, params, bs, opt_state = learn(params, bs, opt_state)
        losses.append(float(loss))
    return config, variables, losses, _np(params), _np(bs)


@pytest.mark.parametrize("fast_bptt,pallas", [(False, False), (True, False), (True, True)])
def test_vdn_grad_steps_match_jax_math(jax_vdn_step, fast_bptt, pallas):
    """Two minibatch steps of `learn_minibatch` on the same window from the
    same weights, through the network's forward, through FAST_BPTT, and
    through FAST_BPTT with the GRU scan's twins: each loss and the params
    after both within 1e-5 of JAX's, batch_stats within 1e-6, no kernel
    launched on the CPU."""
    config, variables, jlosses, new_params, jbs = jax_vdn_step
    tnet = _tnet(variables)
    opt = make_optimizer(tnet.parameters(), config["MAX_GRAD_NORM"], pqn_vdn.vdn_lr(config))
    mb = MARLTransition(**{k: tuple(torch.tensor(x) for x in v) if isinstance(v, tuple) else torch.tensor(v)
                           for k, v in _window().items()}, last_action=torch.zeros(T, A, B, dtype=torch.long),
                        q_val=torch.zeros(T, A, B, N_ACT))
    before = (tgs.gru_scan_fwd.launches, tlr.lambda_returns_closure.launches)
    for want in jlosses:
        loss, chosen = pqn_vdn.learn_minibatch(tnet, opt, mb, config["GAMMA"], config["LAMBDA"], fast_bptt, pallas)
        np.testing.assert_allclose(loss.item(), want, atol=1e-5, rtol=1e-5)
    assert chosen.shape == (T, A, B) and opt.count == 2
    assert (tgs.gru_scan_fwd.launches, tlr.lambda_returns_closure.launches) == before
    want = tckpt.params_from_flax({"params": new_params})
    for name, p in tnet.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-5, rtol=0, err_msg=name)
    for leaf in ("mean", "var"):
        np.testing.assert_allclose(getattr(tnet.BatchNorm_0, leaf).numpy(), jbs["BatchNorm_0"][leaf], atol=1e-6,
                                   rtol=0)


def test_vdn_lr_schedule_is_its_own():
    """LR_LINEAR_DECAY: linear to 1e-10 over NUM_EPOCHS * NUM_MINIBATCHES *
    NUM_UPDATES grad steps (pqn_vdn.py:148-160), as optax computes it."""
    config = {"LR": 3e-4, "LR_LINEAR_DECAY": True, "NUM_EPOCHS": 2, "NUM_MINIBATCHES": 8, "NUM_UPDATES": 10}
    want = optax.linear_schedule(3e-4, 1e-10, 160)
    lr = pqn_vdn.vdn_lr(config)
    for count in (0, 1, 80, 159, 160, 200):
        assert lr(count) == float(np.float32(want(count)))
    assert pqn_vdn.vdn_lr({**config, "LR_LINEAR_DECAY": False}) == 3e-4


# ---- the launch plans at the five configs' shapes -------------------------------------


VDN_SHAPES = {  # (T, rows of a grad step's forward)
    "pqn_vdn_spread": (29, 48), "pqn_vdn_smax": (68, 80), "pqn_vdn_skirmish": (68, 48),
    "pqn_vdn_kitchen": (40, 32), "pqn_vdn_hanabi": (48, 32),
}


@pytest.mark.parametrize("alg", sorted(VDN_SHAPES))
def test_plans_cover_the_vdn_shapes(alg):
    """From each YAML: T = MEMORY_WINDOW + NUM_STEPS and B = agents x
    NUM_ENVS / NUM_MINIBATCHES. The GRU scan's plan at (B, 256): clusters of
    16 CTAs of 16 units, 8 rows each, every row in one cluster, the slice in
    registers; the returns' plan at (T - 1, NUM_ENVS / NUM_MINIBATCHES): one
    block of 16 envs, its chunks covering every step."""
    config = compose(alg=alg, overrides=["DEVICE=cpu"])
    agents = make_marl(config["ENV_NAME"], **(config.get("ENV_KWARGS") or {})).num_agents
    envs = config["NUM_ENVS"] // config["NUM_MINIBATCHES"]
    t, rows = config["MEMORY_WINDOW"] + config["NUM_STEPS"], agents * envs
    assert (t, rows) == VDN_SHAPES[alg]
    plan = tgs.scan_plan(rows, config["HIDDEN_SIZE"])
    assert (plan.cluster, plan.units, plan.rows) == (16, 16, 8) and plan.registers and plan.resident
    covered = [b for k in range(plan.clusters) for b in range(k * plan.rows, min(rows, (k + 1) * plan.rows))]
    assert covered == list(range(rows)) and plan.clusters == rows // 8
    lp = tlr.lambda_plan(t - 1, envs)
    assert (lp.tile, lp.blocks) == (16, 1)
    chunks = -(-(t - 1) // lp.chunk)
    assert lp.stages == min(chunks - 1, 4) and lp.smem_bytes == tlr.lambda_smem_bytes(16, lp.stages)
    steps = [s for k in range(chunks) for s in range(max(0, t - 1 - (k + 1) * lp.chunk), t - 1 - k * lp.chunk)]
    assert sorted(steps) == list(range(t - 1))


# ---- tiny runs, the policy, options, the CLI -------------------------------------------


@pytest.mark.parametrize("alg,extra", [
    ("pqn_vdn_spread", {"FAST_BPTT": True, "PALLAS_BPTT": True, "TEST_NUM_STEPS": 30}),
    ("pqn_vdn_smax", {"DUELING": True, "TEST_NUM_STEPS": 70}),  # episodes of up to 64 steps
])
def test_tiny_vdn_train_counts_and_determinism(alg, extra):
    """The step, update and grad-step counts, finite metrics, the memory
    (MEMORY_WINDOW + NUM_STEPS steps of 5 agents' records), the eval, no
    kernel launch on the CPU, and one result per seed."""
    config = tiny_vdn_config(alg, TEST_DURING_TRAINING=True, TEST_NUM_ENVS=4, TEST_INTERVAL=0.5, **extra)
    before = (tgs.gru_scan_fwd.launches, tgs.gru_scan_bwd.launches, tlr.lambda_returns_closure.launches)
    out = pqn_vdn.make_train(config)()
    m = out["metrics"]
    n_updates = 768 // 8 // 8
    assert int(m["env_step"][-1]) == 768 and int(m["update_steps"][-1]) == n_updates
    assert int(m["grad_steps"][-1]) == n_updates * 2 * 2
    assert all(v.shape == (n_updates,) for v in m.values())
    assert torch.isfinite(m["td_loss"]).all() and torch.isfinite(m["qvals"]).all()
    assert torch.isfinite(m["test/returned_episode_returns"]).all()
    train_state, memory, carry, _ = out["runner_state"]
    agents = 3 if alg == "pqn_vdn_spread" else 5
    assert memory.obs.shape[:3] == (10, agents, 8) and memory.reward.shape == (10, 1, 8)
    assert memory.last_hs[0].shape == (10, agents, 8, 32) and carry[0][0].shape == (agents, 8, 32)
    assert train_state.step == n_updates * 4
    assert (tgs.gru_scan_fwd.launches, tgs.gru_scan_bwd.launches, tlr.lambda_returns_closure.launches) == before
    again = pqn_vdn.make_train(config)()["runner_state"][0]
    for (name, x), y in zip(train_state.network.named_parameters(), again.network.parameters()):
        assert torch.equal(x, y), name
    other = pqn_vdn.make_train(config)(seed=1)["runner_state"][0]
    assert not all(torch.equal(x, y) for x, y in zip(train_state.network.parameters(), other.network.parameters()))


def test_collect_metrics_false_returns_none():
    out = pqn_vdn.make_train(tiny_vdn_config(COLLECT_METRICS=False, TOTAL_TIMESTEPS=128))()
    assert out["metrics"] == {} and out["runner_state"][0].timesteps == 128


def test_cuda_policy_turns_on_the_gru_kernels_for_vdn(capsys):
    for alg in sorted(VDN_SHAPES):
        cfg = compose(alg=alg)
        assert cfg["FAST_BPTT"] is True and cfg["PALLAS_BPTT"] is True, alg
    assert "FAST_BPTT=True, PALLAS_BPTT=True" in capsys.readouterr().err
    for ov in (["DEVICE=cpu"], ["PARITY=strict"], ["DUELING=True"]):
        cfg = compose(alg="pqn_vdn_spread", overrides=ov)
        assert "FAST_BPTT" not in cfg and "PALLAS_BPTT" not in cfg, ov


def _jax_tiny_vdn_config(**kw):
    from purejaxql_tpu.core.config import compose as jax_compose

    return jax_compose(alg="pqn_vdn_spread", overrides=[
        "TOTAL_TIMESTEPS=128", "NUM_ENVS=8", "NUM_STEPS=8", "MEMORY_WINDOW=2", "NUM_MINIBATCHES=2", "NUM_EPOCHS=1",
        "TEST_DURING_TRAINING=False",
    ] + [f"{k}={v}" for k, v in kw.items()])


def test_vdn_hidden_size_defaults_to_256_as_jax():
    """Without the HIDDEN_SIZE key both packages build the VDN network at
    width 256 (pqn_vdn.py:95), not the recurrent trainer's 128: Dense_0's
    flax kernel (14, 256) on Spread (the JAX program traced, not compiled)."""
    from purejaxql_tpu.algo.pqn_vdn import make_train as jax_make_train

    jcfg = _jax_tiny_vdn_config()
    del jcfg["HIDDEN_SIZE"]
    jparams = jax.eval_shape(jax_make_train(jcfg), jax.random.PRNGKey(0))["runner_state"][0].params
    tcfg = tiny_vdn_config(TOTAL_TIMESTEPS=128, NUM_EPOCHS=1)
    del tcfg["HIDDEN_SIZE"]
    tnet = pqn_vdn.make_train(tcfg)()["runner_state"][0].network
    tparams = tckpt.params_to_flax(tnet)["params"]
    assert tuple(jparams["Dense_0"]["kernel"].shape) == tuple(tparams["Dense_0"]["kernel"].shape) == (14, 256)
    shapes = lambda t: jax.tree_util.tree_map(lambda v: tuple(np.shape(v)), t)  # noqa: E731
    assert shapes(tparams) == shapes(jparams)


def test_vdn_ignores_input_norm_type_as_jax():
    """INPUT_NORM_TYPE=batch_renorm: the JAX VDN trainer passes no input norm
    type (pqn_vdn.py:93-104), so both trainers train with the BatchNorm input
    norm, its statistics moved."""
    from purejaxql_tpu.algo.pqn_vdn import make_train as jax_make_train

    jout = jax.jit(jax_make_train(_jax_tiny_vdn_config(HIDDEN_SIZE=16, INPUT_NORM_TYPE="batch_renorm")))(
        jax.random.PRNGKey(0))
    tout = pqn_vdn.make_train(tiny_vdn_config(TOTAL_TIMESTEPS=128, NUM_EPOCHS=1, HIDDEN_SIZE=16,
                                              INPUT_NORM_TYPE="batch_renorm"))()
    jstats = jout["runner_state"][0].batch_stats
    tstats = tckpt.params_to_flax(tout["runner_state"][0].network)["batch_stats"]
    assert set(jstats) == set(tstats) == {"BatchNorm_0"}
    assert np.isfinite(np.asarray(jout["metrics"]["td_loss"])).all()
    assert torch.isfinite(tout["metrics"]["td_loss"]).all()
    assert not np.allclose(tstats["BatchNorm_0"]["mean"], 0.0)


def test_vdn_unsupported_options_raise():
    with pytest.raises(NotImplementedError):
        pqn_vdn.make_train(tiny_vdn_config(ALG_NAME="pqn_rnn"))()
    # LOG_VIA_CALLBACK trains and hands each update's row to the logger's
    # callback, as JAX's
    mem = MemorySink()
    pqn_vdn.make_train(tiny_vdn_config(LOG_VIA_CALLBACK=True, TOTAL_TIMESTEPS=128), logger=MetricLogger([mem]))()
    assert [r["update_steps"] for r in mem.rows] == [1, 2] and all(np.isfinite(r["td_loss"]) for r in mem.rows)
    # an LSTM and a batch_norm trunk train on the module path (held against
    # the JAX trainer in tests/test_torch_vdn_lstm.py); an LSTM on FAST_BPTT
    # raises the KeyError JAX's trainer raises
    for kw, norm in (({"RNN_CELL": "lstm"}, "LayerNorm_1"), ({"NORM_TYPE": "batch_norm"}, "BatchNorm_2")):
        out = pqn_vdn.make_train(tiny_vdn_config(TOTAL_TIMESTEPS=128, NUM_EPOCHS=1, **kw))()
        assert out["runner_state"][0].network.norms[-1] == norm and torch.isfinite(out["metrics"]["td_loss"]).all()
    with pytest.raises(KeyError, match="GRUCell_0"):
        pqn_vdn.make_train(tiny_vdn_config(RNN_CELL="lstm", FAST_BPTT=True))
    with pytest.raises(ValueError, match="FAST_BPTT"):
        pqn_vdn.make_train(tiny_vdn_config(FAST_BPTT=True, DUELING=True))
    with pytest.raises(ValueError, match="NUM_MINIBATCHES"):
        pqn_vdn.make_train(tiny_vdn_config(NUM_MINIBATCHES=3))
    with pytest.raises(ValueError, match="Unknown MARL env"):
        pqn_vdn.make_train(tiny_vdn_config(ENV_NAME="MPE_simple_spread_v3"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pqn_vdn.make_train({**tiny_vdn_config(), "DEVICE": None})


def test_vdn_cli_recipe_writes_what_the_jax_loader_reads(tmp_path, capsys):
    jsonl = tmp_path / "m.jsonl"
    cli.main([
        "+alg=pqn_vdn_spread", "DEVICE=cpu", "TOTAL_TIMESTEPS=512", "NUM_ENVS=8", "NUM_STEPS=8",
        "NUM_MINIBATCHES=2", "NUM_EPOCHS=1", "HIDDEN_SIZE=32", "TEST_NUM_ENVS=4", "TEST_NUM_STEPS=25",
        "TEST_INTERVAL=0.5", f"SAVE_PATH={tmp_path / 'models'}", f"LOG_JSONL={jsonl}",
    ])
    assert "Training took" in capsys.readouterr().out
    run_dir = tmp_path / "models" / "Spread-v0"
    saved = jckpt.load_params(str(run_dir / "pqn_vdn_rnn_Spread-v0_seed0.safetensors"))
    jnet = JRNNQNetwork(action_dim=5, hidden_size=32, num_layers=2, add_last_action=False)
    init = jnet.init(jax.random.PRNGKey(0), jnet.initialize_carry(1), jnp.zeros((1, 1, 14)),
                     jnp.zeros((1, 1)), jnp.zeros((1, 1), jnp.int32), train=False)["params"]
    shapes = lambda t: jax.tree_util.tree_map(lambda v: tuple(np.shape(v)), t)  # noqa: E731
    assert shapes(saved) == shapes(init)
    assert (run_dir / "pqn_vdn_rnn_Spread-v0_seed0_config.yaml").exists()
    rows = [json.loads(line) for line in jsonl.read_text().splitlines()]
    assert len(rows) == 512 // 8 // 8 and rows[-1]["env_step"] == 512
    assert np.isfinite(rows[-1]["test/returned_episode_returns"])


@pytest.mark.slow
def test_vdn_learns_spread():
    """As tests/test_pqn_vdn.py::test_vdn_learns_spread holds the JAX
    package: 400k steps of Spread at 64 envs, H 128, the mean team return of
    the last tenth of updates above the first tenth's by more than 3 (the
    GRU scan's twins, ~10 min on the CPU)."""
    config = compose(alg="pqn_vdn_spread", overrides=[
        "DEVICE=cpu", "TOTAL_TIMESTEPS=400000", "NUM_ENVS=64", "HIDDEN_SIZE=128", "TEST_DURING_TRAINING=False",
        "FAST_BPTT=True", "PALLAS_BPTT=True"])
    rets = pqn_vdn.make_train(config)()["metrics"]["returned_episode_returns"].numpy()
    tenth = max(1, len(rets) // 10)
    early, late = rets[:tenth].mean(), rets[-tenth:].mean()
    assert late > early + 3.0, (early, late)
