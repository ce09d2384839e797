"""The PyTorch port's core (config, schedules, clip + RAdam) against the JAX
package, and the port's isolation from JAX. Runs on the CPU."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import optax
import pytest
import torch
import yaml

from purejaxql_torch.core import config as tconfig
from purejaxql_torch.core import optim as toptim
from purejaxql_torch.core import schedules as tsched
from purejaxql_torch.envs import make as make_env
from purejaxql_tpu.core import config as jconfig
from purejaxql_tpu.core.optim import make_optimizer as jax_make_optimizer

pytestmark = pytest.mark.quick
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


# ---- config -----------------------------------------------------------------


@pytest.mark.parametrize(
    "overrides",
    [
        ["DEVICE=cpu"],
        ["DEVICE=cpu", "NUM_ENVS=64", "alg.LR=0.001", "EPS_TEST=0.05"],
        ["PARITY=strict", "HIDDEN_SIZE=64", "ENV_KWARGS={'max_steps_in_episode': 200}"],
        # pqn_minatar, chosen by the override as on the command line
        ["+alg=pqn_minatar", "DEVICE=cpu", "ENV_NAME=Breakout-MinAtar"],
        ["+alg=pqn_minatar", "PARITY=strict", "TOTAL_TIMESTEPS=5e5", "HIDDEN_SIZE=32"],
        # the recurrent configs, on the CPU and under PARITY=strict
        ["+alg=pqn_rnn_memory_chain", "DEVICE=cpu"],
        ["+alg=pqn_rnn_cartpole", "PARITY=strict", "MEMORY_WINDOW=8"],
    ],
)
def test_compose_matches_jax(overrides):
    want = jconfig.compose(alg="pqn_cartpole", overrides=overrides)
    got = tconfig.compose(alg="pqn_cartpole", overrides=overrides)
    assert got == want


def test_yaml_copies_equal_jax():
    for rel in ("config.yaml", "alg/pqn_cartpole.yaml", "alg/pqn_minatar.yaml",
                "alg/pqn_rnn_cartpole.yaml", "alg/pqn_rnn_memory_chain.yaml", "alg/pqn_pendulum.yaml"):
        mine = yaml.safe_load(open(ROOT / "purejaxql_torch" / "configs" / rel))
        ref = yaml.safe_load(open(ROOT / "purejaxql_tpu" / "configs" / rel))
        assert mine == ref, rel


def test_derive_schedule_keys_matches_jax():
    cfg = jconfig.compose(alg="pqn_cartpole", overrides=["TOTAL_TIMESTEPS=2e5"])
    assert tconfig.derive_pqn_schedule_keys(cfg) == jconfig.derive_pqn_schedule_keys(cfg)
    with pytest.raises(ValueError):
        tconfig.derive_pqn_schedule_keys({**cfg, "NUM_MINIBATCHES": 7})


@pytest.mark.parametrize("raw", ["true", "None", "3", "2e5", "[1, 2]", "abc", "{'a': 1}"])
def test_parse_value_matches_jax(raw):
    assert tconfig._parse_value(raw) == jconfig._parse_value(raw)


def test_compose_opens_no_cuda_context(monkeypatch):
    def _boom(*a, **k):
        raise AssertionError("compose touched the CUDA runtime")

    for name in ("is_available", "init", "device_count", "get_device_name", "current_device"):
        monkeypatch.setattr(torch.cuda, name, _boom)
    cfg = tconfig.compose(alg="pqn_cartpole")
    assert cfg["FUSED_ROLLOUT"] is True


def test_cuda_policy(capsys):
    cfg = tconfig.compose(alg="pqn_cartpole")
    assert cfg["FUSED_ROLLOUT"] is True and cfg["EVAL_EARLY_EXIT"] is True
    assert "FUSED_ROLLOUT=True" in capsys.readouterr().err
    # the CPU and PARITY=strict leave the config as the YAML has it
    for ov in (["DEVICE=cpu"], ["PARITY=strict"]):
        cfg = tconfig.compose(alg="pqn_cartpole", overrides=ov)
        assert "FUSED_ROLLOUT" not in cfg and "EVAL_EARLY_EXIT" not in cfg
    # explicitly set flags win
    cfg = tconfig.compose(alg="pqn_cartpole", overrides=["FUSED_ROLLOUT=False"])
    assert cfg["FUSED_ROLLOUT"] is False and "EVAL_EARLY_EXIT" not in cfg
    cfg = tconfig.compose(alg="pqn_cartpole", overrides=["EVAL_EARLY_EXIT=False"])
    assert cfg["FUSED_ROLLOUT"] is True and cfg["EVAL_EARLY_EXIT"] is False
    # ineligible configs stay unfused
    for ov in (["NUM_LAYERS=3"], ["NORM_TYPE=batch_norm"], ["NUM_SEEDS=2"], ["NORM_INPUT=True"]):
        assert "FUSED_ROLLOUT" not in tconfig.compose(alg="pqn_cartpole", overrides=ov)


def test_cuda_policy_breakout():
    """On cuda the policy fuses the rollout and eval of every MinAtar game
    the port has a kernel for, Breakout and the YAML's default game
    (Asterix) among them; an env the port has not ported (Acrobot) is not
    eligible and stays unknown to the port's registry."""
    for game in ("Asterix", "Breakout", "Freeway", "Seaquest", "SpaceInvaders"):
        cfg = tconfig.compose(alg="pqn_minatar", overrides=[f"ENV_NAME={game}-MinAtar"])
        assert cfg["FUSED_ROLLOUT"] is True and cfg["EVAL_EARLY_EXIT"] is True, game
    assert "FUSED_ROLLOUT" not in tconfig.compose(
        alg="pqn_minatar", overrides=["ENV_NAME=Breakout-MinAtar", "NORM_INPUT=True"]
    )
    cfg = tconfig.compose(alg="pqn_minatar", overrides=["ENV_NAME=Acrobot-v1"])
    assert "FUSED_ROLLOUT" not in cfg and "EVAL_EARLY_EXIT" not in cfg
    with pytest.raises(ValueError, match="Unknown env"):
        make_env(cfg["ENV_NAME"])
    assert tconfig.compose(alg="pqn_minatar")["ENV_NAME"] == "Asterix-MinAtar"


@pytest.mark.parametrize(
    "alg,overrides,fused",
    [
        ("pqn_cartpole", ["ENV_KWARGS={'max_steps_in_episode': 200}"], True),
        ("pqn_cartpole", ["ENV_KWARGS={'gravity': 9.0}"], False),
        ("pqn_minatar", ["ENV_KWARGS={'ramping': False}"], False),
        ("pqn_minatar", ["ENV_KWARGS={'max_steps_in_episode': 300, 'init_spawn_speed': 8}"], False),
        ("pqn_minatar", ["ENV_NAME=Seaquest-MinAtar", "ENV_KWARGS={'max_steps_in_episode': 300}"], True),
        ("pqn_minatar", ["ENV_NAME=Seaquest-MinAtar", "ENV_KWARGS={'max_oxygen': 100}"], False),
    ],
)
def test_cuda_policy_fuses_only_what_the_trainer_builds(alg, overrides, fused):
    """The cuda policy and the FF trainer share one predicate
    (algo/pqn.py:fused_ff_eligible): with ENV_KWARGS on a game whose kernel
    keeps its env params built in (CartPole, Asterix, Seaquest), the policy
    fuses the rollout only where max_steps_in_episode alone is set, which
    every kernel takes; the trainer then builds the config it composed, and
    refuses FUSED_ROLLOUT where the policy left it off."""
    from purejaxql_torch.algo import pqn

    cfg = tconfig.compose(alg=alg, overrides=overrides)
    assert cfg.get("FUSED_ROLLOUT", False) is fused
    assert pqn.fused_ff_eligible(cfg) is fused
    pqn.make_train(cfg, device="cpu")
    if not fused:
        with pytest.raises(ValueError, match="ENV_KWARGS"):
            pqn.make_train({**cfg, "FUSED_ROLLOUT": True}, device="cpu")


def test_compose_errors():
    with pytest.raises(ValueError, match="Available"):
        tconfig.compose(alg="nonexistent")
    with pytest.raises(ValueError, match="KEY=value"):
        tconfig.compose(alg="pqn_cartpole", overrides=["BADOVERRIDE"])


# ---- schedules -------------------------------------------------------------


@pytest.mark.parametrize(
    "init,end,steps",
    [(1.0, 0.2, 0.2 * 97), (1e-4, 1e-20, 97 * 16 * 4), (1.0, 0.05, 10), (0.3, 0.1, 0), (0.3, 0.1, -5)],
)
def test_linear_schedule_matches_optax(init, end, steps):
    mine = tsched.linear_schedule(init, end, steps)
    ref = optax.linear_schedule(init, end, steps)
    for count in [0, 1, 2, 5, 17, 19, 20, 100, 6207, 6208, 6209, 10**5]:
        want = np.float32(ref(count))
        assert np.float32(mine(count)) == want, (count, mine(count), want)


def test_lr_schedule_matches_jax():
    from purejaxql_tpu.core.schedules import lr_schedule as jlr

    cfg = jconfig.derive_pqn_schedule_keys(
        jconfig.compose(alg="pqn_cartpole", overrides=["TOTAL_TIMESTEPS=2e5"])
    )
    mine, ref = tsched.lr_schedule(cfg), jlr(cfg)
    for count in (0, 1, 3000, 6207, 6208, 9999):
        assert np.float32(mine(count)) == np.float32(ref(count))
    cfg["LR_LINEAR_DECAY"] = False
    assert tsched.lr_schedule(cfg) == jlr(cfg) == cfg["LR"]


# ---- clip + RAdam ------------------------------------------------------------


@pytest.mark.parametrize("lr_kind", ["const", "schedule"])
def test_clip_radam_matches_optax(lr_kind):
    """12 steps cover rho below and above the rectification threshold 5,
    and gradients both below and above the clip norm."""
    rng = np.random.RandomState(0)
    shapes = [(4, 8), (8,), (8, 3), (3,)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    if lr_kind == "const":
        lr_t, lr_j = 1e-3, 1e-3
    else:
        lr_t = tsched.linear_schedule(1e-2, 1e-20, 9)
        lr_j = optax.linear_schedule(1e-2, 1e-20, 9)
    tx = jax_make_optimizer(1.0, lr_j)
    import jax.numpy as jnp

    jparams = [jnp.asarray(p) for p in params]
    state = tx.init(jparams)
    tparams = [torch.tensor(p) for p in params]
    opt = toptim.make_optimizer(tparams, 1.0, lr_t)
    for step in range(12):
        scale = 3.0 if step % 2 else 0.05  # global norm above / below 1
        grads = [(scale * rng.randn(*s)).astype(np.float32) for s in shapes]
        upd, state = tx.update([jnp.asarray(g) for g in grads], state, jparams)
        jparams = optax.apply_updates(jparams, upd)
        opt.step([torch.tensor(g) for g in grads])
        # rtol 1e-6 of each tensor's scale: the global norm is summed in
        # another order than XLA's, so the clipped gradients may differ in
        # the last bit, which shows relatively only in elements of a moment
        # that nearly cancel
        radam_state = state[1][0]
        pairs = zip(
            tparams + list(opt.mu) + list(opt.nu),
            list(jparams) + list(radam_state.mu) + list(radam_state.nu),
        )
        for got, want in pairs:
            want = np.asarray(want)
            np.testing.assert_allclose(
                got.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max()
            )
    assert opt.count == int(radam_state.count) == 12


def test_rho_crosses_threshold():
    b2 = 0.999
    ro_inf = 2 / (1 - b2) - 1
    rho = [ro_inf - 2 * t * b2**t / (1 - b2**t) for t in range(1, 13)]
    assert min(rho) < 5.0 < max(rho)


# ---- package isolation -----------------------------------------------------------

_BLOCKED = ("jax", "jaxlib", "flax", "optax", "chex", "purejaxql_tpu")


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        f"for m in {_BLOCKED!r}: sys.modules[m] = None\n"
        "import importlib, pkgutil, purejaxql_torch\n"
        "for m in pkgutil.walk_packages(purejaxql_torch.__path__, 'purejaxql_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT, env=env,
        timeout=120,
    )
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_port_sources_name_no_jax_module():
    pat = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|chex|purejaxql_tpu)\b", re.M
    )
    files = list((ROOT / "purejaxql_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = [str(f) for f in files if pat.search(f.read_text())]
    assert not bad, bad
