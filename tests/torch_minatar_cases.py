"""Helpers the MinAtar game tests of the port share (tests/test_torch_asterix.py,
tests/test_torch_freeway.py, tests/test_torch_seaquest.py,
tests/test_torch_space_invaders.py): flax and
port networks on the same weights, states in both packages, the comparison
of a plain twin with its Pallas kernel, the tiny trainer run, and the check
of a cluster kernel's launch plan."""

import dataclasses
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import torch

from purejaxql_torch.algo import pqn
from purejaxql_torch.core import checkpoint as tckpt
from purejaxql_torch.core.config import compose
from purejaxql_torch.models.cnn import CNNQNetwork as TCNNQNetwork
from purejaxql_torch.ops import lambda_returns as tlr
from purejaxql_torch.ops import minatar_rollout as tmr
from purejaxql_tpu.envs import make as jmake
from purejaxql_tpu.models.cnn import CNNQNetwork as JCNNQNetwork

ROLLOUT_NAMES = ("obs", "act", "rew", "done", "q", "final_obs")


def cnn_pair(channels, actions, seed=0, hidden=32):
    """A flax CNNQNetwork with every leaf perturbed (0.05 randn on the params,
    |randn| on the batch statistics) and the port's network on the same
    weights."""
    jnet = JCNNQNetwork(action_dim=actions, hidden_size=hidden)
    variables = jnet.init(jax.random.PRNGKey(seed), jnp.zeros((1, 10, 10, channels)), train=False)
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.05 * rng.randn(*np.shape(x))).astype(np.float32), variables["params"]
    )
    stats = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + np.abs(rng.randn(*np.shape(x)))).astype(np.float32), variables["batch_stats"]
    )
    variables = {"params": params, "batch_stats": stats}
    tnet = TCNNQNetwork((10, 10, channels), actions, hidden_size=hidden)
    tnet.load_state_dict(tckpt.params_from_flax(variables))
    return jnet, variables, tnet


def boards(n, channels, seed):
    """MinAtar-like observations: (n, 10, 10, C) planes of 0s and 1s."""
    return (np.random.RandomState(seed).rand(n, 10, 10, channels) < 0.2).astype(np.float32)


def check_cnn_matches_flax_and_crosses(channels, actions, tmp_path):
    """The port's CNN at C channels gives flax's Q-values in eval and train
    mode within 1e-5, and its params cross to flax's loader and back with
    the conv kernel as (3, 3, C, 16) HWIO."""
    jnet, variables, tnet = cnn_pair(channels, actions, seed=channels)
    obs = boards(48, channels, 1)
    for train in (False, True):
        want = jnet.apply(variables, jnp.asarray(obs), train=train, mutable=["batch_stats"] if train else False)
        want = want[0] if train else want
        with torch.no_grad():
            got = tnet(torch.tensor(obs), train=train)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    from purejaxql_tpu.core import checkpoint as jckpt

    path = str(tmp_path / "port.safetensors")
    tckpt.save_params(tckpt.params_to_flax(tnet)["params"], path)
    jparams = jckpt.load_params(path)
    assert jparams["CNN_0"]["Conv_0"]["kernel"].shape == (3, 3, channels, 16)
    np.testing.assert_array_equal(jparams["CNN_0"]["Conv_0"]["kernel"], variables["params"]["CNN_0"]["Conv_0"]["kernel"])
    back = TCNNQNetwork((10, 10, channels), actions, hidden_size=32)
    back.load_state_dict(tckpt.params_from_flax(tckpt.load_params(path)), strict=False)
    assert torch.equal(back.CNN_0.Conv_0.weight, tnet.CNN_0.Conv_0.weight)
    assert back.CNN_0.Conv_0.weight.shape == (16, channels, 3, 3)


def to_torch(cls, jstate):
    """A port state dataclass from a JAX one (or a dict of arrays) with the
    same field names."""
    get = jstate.get if isinstance(jstate, dict) else lambda k: getattr(jstate, k)
    return cls(**{f.name: torch.tensor(np.asarray(get(f.name))) for f in dataclasses.fields(cls)})


def random_play_states(env_name, n_envs, n_steps, seed, n_actions):
    """The states random play reaches in the JAX package (auto-reset on),
    every step of every env, as a dict of numpy arrays."""
    env, params = jmake(env_name)
    _, state = jax.vmap(env.reset, in_axes=(0, None))(jax.random.split(jax.random.PRNGKey(seed), n_envs), params)
    step = jax.jit(jax.vmap(env.step, in_axes=(0, 0, 0, None)))
    rng = np.random.RandomState(seed)
    seen = []
    for t in range(n_steps):
        seen.append(jax.tree_util.tree_map(np.asarray, state))
        _, state, *_ = step(
            jax.random.split(jax.random.PRNGKey(1000 + t), n_envs), state,
            jnp.asarray(rng.randint(0, n_actions, n_envs)), params,
        )
    fields = [f.name for f in dataclasses.fields(type(state))]
    return {f: np.concatenate([getattr(s, f) for s in seen]) for f in fields}


def jax_step_env(env_name, cols, actions, keys):
    """The JAX env's step_env over a batch given as a dict of arrays, jitted
    (one compile is a few times faster than the op-by-op dispatch of a new
    batch shape)."""
    env, params = jmake(env_name)
    _, jstate = jax.vmap(env.reset, in_axes=(0, None))(keys, params)
    jstate = jstate.replace(**{k: jnp.asarray(v) for k, v in cols.items()})
    step = jax.jit(jax.vmap(env.step_env, in_axes=(0, 0, 0, None)))
    return step(keys, jstate, jnp.asarray(actions), params)


def assert_same_step(jout, tout):
    """obs, reward, done and every state field exactly equal."""
    (jobs, jst, jrew, jdone, _), (tobs, tst, trew, tdone, _) = jout, tout
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
    np.testing.assert_array_equal(trew.numpy(), np.asarray(jrew))
    np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
    for f in dataclasses.fields(tst):
        np.testing.assert_array_equal(
            getattr(tst, f.name).numpy(), np.asarray(getattr(jst, f.name)), err_msg=f.name
        )


def assert_twin_matches_pallas(got, want, n_actions):
    """A plain twin's outputs against its Pallas kernel's (interpret mode,
    PRNG off): every output equal but Q, which is within 1e-4 (the TPU head
    is padded to 8 rows)."""
    names = ROLLOUT_NAMES + tuple(f"state{i}" for i in range(len(got) - len(ROLLOUT_NAMES)))
    assert len(got) == len(want)
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        if name == "q":
            np.testing.assert_allclose(g.numpy(), w[..., :n_actions], atol=1e-4, rtol=0)
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def tiny_config(**kw):
    return compose(
        alg="pqn_minatar",
        overrides=[
            "DEVICE=cpu", "TOTAL_TIMESTEPS=2048", "TOTAL_TIMESTEPS_DECAY=2048", "NUM_ENVS=8",
            "NUM_STEPS=16", "NUM_MINIBATCHES=2", "NUM_EPOCHS=2", "HIDDEN_SIZE=32",
        ] + [f"{k}={v}" for k, v in kw.items()],
    )


def check_tiny_train(env_name, fused, channels, rollout):
    """The game with the MinAtar CNN, fused (the rollout's plain twin on the
    CPU) or unfused, with the in-loop eval on: the step, update and
    grad-step counts, finite losses, the CNN's flax-named parameters at C
    channels, no kernel launch on the CPU, and one result per seed."""
    config = tiny_config(
        ENV_NAME=env_name, FUSED_ROLLOUT=fused, EVAL_EARLY_EXIT=fused, TEST_DURING_TRAINING=True,
        TEST_NUM_ENVS=8, TEST_NUM_STEPS=48, TEST_INTERVAL=0.5,
    )
    before = (tlr.lambda_returns.launches, rollout.launches)
    a = pqn.make_train(config)()
    m = a["metrics"]
    n_updates = 2048 // 16 // 8
    assert int(m["env_step"][-1]) == 2048 and int(m["update_steps"][-1]) == n_updates
    assert int(m["grad_steps"][-1]) == n_updates * 2 * 2
    assert all(v.shape == (n_updates,) for v in m.values())
    assert torch.isfinite(m["td_loss"]).all() and torch.isfinite(m["qvals"]).all()
    assert "test/returned_episode_returns" in m
    ts = a["runner_state"][0]
    assert ts.params["CNN_0.Conv_0.weight"].shape == (16, channels, 3, 3)
    assert ts.batch_stats["BatchNorm_0.mean"].shape == (channels,)
    obs, _ = a["runner_state"][1]
    assert obs.shape == (8, 10, 10, channels)
    assert (tlr.lambda_returns.launches, rollout.launches) == before
    b = pqn.make_train(config)()
    assert torch.equal(m["td_loss"], b["metrics"]["td_loss"])
    c = pqn.make_train(config)(seed=1)
    assert not torch.equal(m["td_loss"], c["metrics"]["td_loss"])


def check_wrapper_on_cpu(rollout, weights, states, channels, actions):
    """The wrapper takes the plain twin for CPU tensors without counting a
    launch, returns the kernel's output shapes, and refuses other devices."""
    before = rollout.launches
    B, T = states[0].shape[-1], 3
    out = rollout(0, 0.0, weights, *states, T)
    assert [tuple(o.shape) for o in out] == [
        (T, B, 10, 10, channels), (T, B), (T, B), (T, B), (T, B, actions), (B, 10, 10, channels),
    ] + [tuple(x.shape) for x in states]
    assert [o.dtype for o in out[1:4]] == [torch.int32, torch.float32, torch.int32]
    assert rollout.launches == before
    try:
        rollout(0, 0.0, weights, *(x.to("meta") for x in states), T)
    except ValueError as e:
        assert "unsupported device" in str(e)
    else:
        raise AssertionError("a meta tensor was accepted")


CSRC = pathlib.Path(tmr.__file__).parents[1] / "csrc"


def header_smem_bytes(channels, H, C, game_ints):
    """csrc/minatar_cluster.cuh `smem_floats` in bytes, its return expression
    read from the header and evaluated with the header's constants."""
    src = (CSRC / "minatar_cluster.cuh").read_text()
    expr = re.search(r"inline int smem_floats\(int kCh, int H, int C, int game_ints\) \{\s*return (.*?);", src, re.S)
    names = dict(
        kFlat=1024, kCells=100, kFeatures=16, kMaxActions=8, kCh=channels, H=H, C=C, game_ints=game_ints,
        round4=lambda n: (n + 3) // 4 * 4, chunks_of=lambda h, c: 256 // (h // 4 * (2 if c > 1 else 1)),
    )
    return 4 * eval("(" + expr.group(1).replace("/", "//") + ")", {}, names)


def check_cluster_plan(plan_fn, B, H, channels, game_ints, source):
    """A MinAtar kernel's launch plan on the cluster CNN (csrc/minatar_cluster.cuh):
    clusters of at most 16 CTAs, one env a CTA, so every env has one owner
    CTA; CTA r of a cluster holds the dense weight's columns [r F, (r + 1) F),
    so every conv output (a column) has one owner and the whole dense weight
    sits on chip; the shared bytes are the header's formula with the game's
    ints as its kernel counts them (``kGameInts`` of ``source``), within 227
    KB, and at H 128 within the 113 KB at which two CTAs share an SM."""
    built_in = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", (CSRC / source).read_text())}
    assert built_in["kGameInts"] == game_ints
    plan = plan_fn(B, H)
    assert plan.cluster in (1, 2, 4, 8, 16) and plan.threads == 256
    owners = [(k, r) for k in range(plan.clusters) for r in range(plan.cluster) if k * plan.cluster + r < B]
    assert [k * plan.cluster + r for k, r in owners] == list(range(B))
    columns = [f for r in range(plan.cluster) for f in range(r * plan.columns, (r + 1) * plan.columns)]
    assert columns == list(range(1024))
    threads = plan.chunks * (H // 4) * min(2, plan.cluster)  # a unit quad, env half and chunk each
    assert threads <= 256 < threads + (H // 4) * min(2, plan.cluster)
    assert plan.smem_bytes == header_smem_bytes(channels, H, plan.cluster, game_ints) <= tmr.SMEM_LIMIT
    assert plan.smem_bytes >= 4 * H * plan.columns  # the dense weight's slice, resident
    if H == 128:
        assert plan.cluster == 16 and plan.smem_bytes <= tmr.TWO_CTAS_AN_SM == 113 * 1024
    if (B, H) == (128, 128):
        assert (plan.cluster, plan.clusters) == (16, 8)
