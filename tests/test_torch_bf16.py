"""BF16_COMPUTE in the port on the CPU, against the JAX package: the MLP with
pqn_craftax's input BatchRenorm and the MinAtar CNN in bfloat16 against the
flax modules with ``dtype=bfloat16`` on the same weights and against their own
float32 forwards, one learn step of each under BF16_COMPUTE against JAX's, and
tiny CLI runs of the two new programs (pqn_craftax with RESET_BANK,
FAST_TARGETS and BF16_COMPUTE; Breakout with BF16_COMPUTE through the fused
rollout's twin).

Tolerances: bfloat16 keeps 8 significant bits, so one rounding step of a
Q-value near 2 is 2**-6. The port and flax round the same products in the same
places (the product, then the bias add), and the Q-values agree bit for bit
here; a matmul may sum in another order elsewhere, so the bound is two steps
(2**-5) with at least 95 % of the values equal. Against float32 the trunk's roundings add up:
within 0.05 here (0.015-0.018 measured at these widths and at H 1024 x 4)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from purejaxql_tpu.core.optim import make_optimizer as jax_make_optimizer
from purejaxql_tpu.core.schedules import lr_schedule as jax_lr_schedule
from purejaxql_tpu.models.cnn import CNNQNetwork as JCNNQNetwork
from purejaxql_tpu.models.qnet import QNetwork as JQNetwork
from purejaxql_torch import cli
from purejaxql_torch.algo import pqn
from purejaxql_torch.core import checkpoint as tckpt
from purejaxql_torch.core.config import compose, derive_pqn_schedule_keys
from purejaxql_torch.core.optim import make_optimizer
from purejaxql_torch.core.schedules import lr_schedule
from purejaxql_torch.models.cnn import CNNQNetwork as TCNNQNetwork
from purejaxql_torch.models.factory import make_q_network
from purejaxql_torch.models.qnet import QNetwork as TQNetwork

torch.set_num_threads(1)

OBS_DIM, N_ACTIONS = 2883, 34
BF16_STEP = 2.0**-5  # two bfloat16 rounding steps of a value in [2, 4)
F32_BOUND = 0.05


def _mlp(dtype_j, dtype_t):
    return (
        JQNetwork(action_dim=N_ACTIONS, hidden_size=64, num_layers=2, norm_input=True,
                  input_norm_type="batch_renorm", dtype=dtype_j),
        TQNetwork(OBS_DIM, N_ACTIONS, hidden_size=64, num_layers=2, norm_input=True,
                  input_norm_type="batch_renorm", dtype=dtype_t),
    )


def _cnn(dtype_j, dtype_t):
    return (JCNNQNetwork(action_dim=3, hidden_size=32, dtype=dtype_j),
            TCNNQNetwork((10, 10, 4), 3, hidden_size=32, dtype=dtype_t))


def _forager_like_obs(rng, n):
    obs = (rng.rand(n, OBS_DIM) < 0.03).astype(np.float32)
    obs[:, -48:] = rng.rand(n, 48).astype(np.float32)
    return obs


# per network: its pair of modules by dtype, an observation batch, its alg
NETS = {
    "mlp_input_batch_renorm": (_mlp, (1, OBS_DIM), lambda rng: _forager_like_obs(rng, 256), "pqn_craftax"),
    "minatar_cnn": (_cnn, (1, 10, 10, 4), lambda rng: (rng.rand(128, 10, 10, 4) < 0.2).astype(np.float32),
                    "pqn_minatar"),
}


def _pair(kind, seed=0):
    """The flax and port networks in bfloat16 and in float32 on the same
    (perturbed) weights."""
    make, init_shape, _, _ = NETS[kind]
    jb, tb = make(jnp.bfloat16, torch.bfloat16)
    jf, tf = make(jnp.float32, torch.float32)
    variables = jf.init(jax.random.PRNGKey(seed), jnp.zeros(init_shape), train=False)
    rng = np.random.RandomState(seed)
    variables = {
        "params": jax.tree_util.tree_map(lambda x: np.asarray(x) + 0.05 * rng.randn(*x.shape).astype(np.float32),
                                         variables["params"]),
        "batch_stats": jax.tree_util.tree_map(np.asarray, variables["batch_stats"]),
    }
    sd = tckpt.params_from_flax(variables)
    tb.load_state_dict(sd)
    tf.load_state_dict(sd)
    return jb, jf, tb, tf, variables


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("kind", sorted(NETS))
def test_bf16_forward_matches_flax_and_stays_near_f32(kind, train):
    """The bfloat16 forward against flax's ``dtype=bfloat16`` module on the
    same weights (float32 Q-values within two bfloat16 steps, 95 % equal),
    and against its own float32 forward within F32_BOUND; train mode's
    statistics update equal to flax's (the input norm runs in float32)."""
    jb, jf, tb, tf, variables = _pair(kind)
    obs = NETS[kind][2](np.random.RandomState(1))
    if train:
        want, upd = jb.apply(variables, jnp.asarray(obs), train=True, mutable=["batch_stats"])
    else:
        want = jb.apply(variables, jnp.asarray(obs), train=False)
    want = np.asarray(want)
    with torch.no_grad():
        got = tb(torch.tensor(obs), train=train)
        f32 = tf(torch.tensor(obs), train=train).numpy()
    assert got.dtype == torch.float32 and want.dtype == np.float32
    got = got.numpy()
    np.testing.assert_allclose(got, want, atol=BF16_STEP, rtol=0)
    assert (got == want).mean() > 0.95
    assert 0 < np.abs(got - f32).max() < F32_BOUND
    if train:
        stats = tckpt.params_to_flax(tb)["batch_stats"]
        for name, leaves in jax.tree_util.tree_map(np.asarray, upd["batch_stats"]).items():
            for leaf, value in leaves.items():
                np.testing.assert_allclose(stats[name][leaf], value, atol=1e-6, rtol=1e-6, err_msg=f"{name}/{leaf}")


def test_bf16_trunk_activations_are_bf16_and_params_f32():
    """Forward hooks: every Dense, LayerNorm and the conv of the trunk hand on
    bfloat16; the input norm float32; every parameter and buffer float32."""
    for kind in NETS:
        _, _, tb, _, _ = _pair(kind)
        seen = {}
        for name, module in tb.named_modules():
            if name and not list(module.children()):
                module.register_forward_hook(lambda m, i, o, name=name: seen.__setitem__(name, o.dtype))
        with torch.no_grad():
            tb(torch.tensor(NETS[kind][2](np.random.RandomState(2))), train=True)
        input_norm = "BatchRenorm_0" if kind.startswith("mlp") else "BatchNorm_0"
        assert seen.pop(input_norm) == torch.float32
        assert seen and set(seen.values()) == {torch.bfloat16}, seen
        assert {t.dtype for t in tb.state_dict().values()} <= {torch.float32, torch.int32}


def _jax_loss_fn(jnet, batch_stats, obs, act, tgt):
    def loss_fn(p):
        q, upd = jnet.apply({"params": p, "batch_stats": batch_stats}, jnp.asarray(obs), train=True,
                            mutable=["batch_stats"])
        chosen = jnp.take_along_axis(q, jnp.asarray(act)[:, None], axis=-1).squeeze(-1)
        return 0.5 * jnp.square(chosen - tgt).mean(), upd

    return loss_fn


@pytest.mark.parametrize("kind", sorted(NETS))
def test_bf16_learn_step_matches_jax(kind):
    """One minibatch step under BF16_COMPUTE from the same weights and batch:
    the MinAtar CNN on given lambda targets (pqn.py:504-514,
    ``learn_minibatch``), the craftax MLP by FAST_TARGETS
    (``learn_minibatch_fast_td``), each against JAX's composition with the
    flax ``dtype=bfloat16`` module and the config's clip + RAdam. The loss
    within 1e-2 relative; the statistics within 1e-5 (the input norm runs
    in float32); each parameter's update within 10 % of that tensor's
    largest JAX update plus two float32 steps of the parameter: a gradient
    summed over a broadcast is rounded differently by XLA on the CPU, which
    sums bfloat16 terms in bfloat16 (the conv bias's 128 x 8 x 8: 4 % of
    its largest gradient off the exact sum here, the port's 0.2 %); the
    parameters stay float32."""
    jb, _, tb, _, variables = _pair(kind, seed=3)
    obs_fn, alg = NETS[kind][2], NETS[kind][3]
    config = derive_pqn_schedule_keys(compose(alg=alg, overrides=["DEVICE=cpu", "BF16_COMPUTE=True"]))
    tx = jax_make_optimizer(config["MAX_GRAD_NORM"], jax_lr_schedule(config))
    params, batch_stats = variables["params"], variables["batch_stats"]
    opt = make_optimizer(tb.parameters(), config["MAX_GRAD_NORM"], lr_schedule(config))
    rng = np.random.RandomState(4)
    gamma = config["GAMMA"]
    obs, next_obs = obs_fn(rng), obs_fn(rng)
    n = obs.shape[0]
    act = rng.randint(0, tb.action_dim, n).astype(np.int32)
    rew = rng.choice([0.0, 0.1, -0.1, 1.0], n).astype(np.float32)
    done = rng.rand(n) < 0.1
    if alg == "pqn_craftax":
        q_next, _ = jb.apply(variables, jnp.asarray(next_obs), train=True, mutable=["batch_stats"])
        tgt = jnp.asarray(rew) + (1 - jnp.asarray(done)) * gamma * jnp.max(q_next, axis=-1)
    else:
        tgt = jnp.asarray(rng.randn(n).astype(np.float32))
    (jloss, upd), grads = jax.value_and_grad(_jax_loss_fn(jb, batch_stats, obs, act, tgt), has_aux=True)(params)
    updates, _ = tx.update(grads, tx.init(params), params)
    want = tckpt.params_from_flax({
        "params": jax.tree_util.tree_map(np.asarray, optax.apply_updates(params, updates)),
        "batch_stats": jax.tree_util.tree_map(np.asarray, upd["batch_stats"]),
    })
    before = {k: v.numpy().copy() for k, v in tb.state_dict().items()}
    t = torch.tensor
    if alg == "pqn_craftax":
        loss, _ = pqn.learn_minibatch_fast_td(tb, opt, t(obs), t(act).long(), t(next_obs), t(rew), t(done), gamma)
    else:
        loss, _ = pqn.learn_minibatch(tb, opt, t(obs), t(act).long(), t(np.asarray(tgt)))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-2)
    trainable = dict(tb.named_parameters())
    for name, got in tb.state_dict().items():
        if name in trainable:
            step = want[name].numpy() - before[name]
            tol = 0.1 * np.abs(step).max() + 2 * np.finfo(np.float32).eps * np.abs(before[name]).max()
            np.testing.assert_allclose(got.numpy() - before[name], step, atol=tol, rtol=0, err_msg=name)
        else:
            np.testing.assert_allclose(got.numpy(), want[name].numpy(), atol=1e-5, rtol=0, err_msg=name)
    assert all(p.dtype == torch.float32 for p in tb.parameters())


def test_factory_gives_bf16_and_raises_where_not_ported():
    """make_q_network with BF16_COMPUTE: a bfloat16 trunk for the MLP and the
    MinAtar CNN; a BatchRenorm trunk (craftax with NORM_TYPE batch_norm) and
    the Nature trunk build in bfloat16 too, and their forwards hand back
    float32 Q-values (both held against flax in
    tests/test_torch_norm_variants.py)."""
    for alg, shape, cls in (("pqn_craftax", (OBS_DIM,), TQNetwork), ("pqn_minatar", (10, 10, 4), TCNNQNetwork),
                            ("pqn_cartpole", (4,), TQNetwork)):
        net = make_q_network(compose(alg=alg, overrides=["DEVICE=cpu", "BF16_COMPUTE=True", "HIDDEN_SIZE=16"]),
                             3, shape)
        assert isinstance(net, cls) and net.dtype == torch.bfloat16
    renorm = make_q_network(compose(alg="pqn_craftax", overrides=["DEVICE=cpu", "BF16_COMPUTE=True",
                                                                  "NORM_TYPE=batch_norm", "HIDDEN_SIZE=16"]),
                            3, (OBS_DIM,))
    assert renorm.dtype == torch.bfloat16
    assert [n for _, n in renorm.layers] == [f"BatchRenorm_{i + 1}" for i in range(len(renorm.layers))]
    nature = make_q_network({"NORM_TYPE": "layer_norm", "BF16_COMPUTE": True, "CNN_TRUNK": "nature"}, 3,
                            (84, 84, 4))
    assert nature.dtype == torch.bfloat16
    for net, x in ((renorm, torch.tensor(_forager_like_obs(np.random.RandomState(0), 8))),
                   (nature, torch.rand(2, 84, 84, 4) * 255)):
        q = net(x, train=True)
        assert q.dtype == torch.float32 and torch.isfinite(q).all()


def _cli(tmp_path, *args):
    jsonl = tmp_path / "m.jsonl"
    cli.main([*args, "DEVICE=cpu", f"SAVE_PATH={tmp_path / 'models'}", f"LOG_JSONL={jsonl}"])
    return [json.loads(line) for line in jsonl.read_text().splitlines()]


def test_cli_craftax_fast_program_in_bf16(tmp_path, capsys):
    """pqn_craftax through the CLI at H 64 x 2, 64 envs, with RESET_BANK,
    FAST_TARGETS (so SKIP_NOOP_PERMUTE) and BF16_COMPUTE: 32 rows, finite,
    the params saved in float32 with flax's names."""
    rows = _cli(tmp_path, "+alg=pqn_craftax", "TOTAL_TIMESTEPS=2048", "TOTAL_TIMESTEPS_DECAY=2048", "NUM_ENVS=64",
                "HIDDEN_SIZE=64", "NUM_LAYERS=2", "RESET_BANK=16", "RESET_BANK_REFRESH_EVERY=4",
                "FAST_TARGETS=True", "BF16_COMPUTE=True")
    assert "Training took" in capsys.readouterr().out
    assert len(rows) == 32 and rows[-1]["env_step"] == 2048 and np.isfinite(rows[-1]["td_loss"])
    saved = tckpt.load_params(str(tmp_path / "models" / "Craftax-Symbolic-v1" /
                                  "pqn_craftax_Craftax-Symbolic-v1_seed0.safetensors"))
    assert saved["Dense_0"]["kernel"].shape == (OBS_DIM, 64) and saved["Dense_0"]["kernel"].dtype == torch.float32


def test_cli_breakout_in_bf16_through_the_fused_twin(tmp_path, capsys):
    """Breakout with BF16_COMPUTE and FUSED_ROLLOUT (the kernel's twin here,
    reading the float32 master weights as the JAX package's kernel does; the
    lambda targets' last Q and the learn phase in bfloat16): 16 rows, finite,
    float32 params saved."""
    rows = _cli(tmp_path, "+alg=pqn_minatar", "ENV_NAME=Breakout-MinAtar", "TOTAL_TIMESTEPS=2048",
                "TOTAL_TIMESTEPS_DECAY=2048", "NUM_ENVS=8", "NUM_STEPS=16", "NUM_MINIBATCHES=2", "NUM_EPOCHS=2",
                "HIDDEN_SIZE=32", "TEST_DURING_TRAINING=False", "FUSED_ROLLOUT=True", "BF16_COMPUTE=True")
    assert "Training took" in capsys.readouterr().out
    assert len(rows) == 16 and rows[-1]["env_step"] == 2048 and np.isfinite(rows[-1]["td_loss"])
    saved = tckpt.load_params(str(tmp_path / "models" / "Breakout-MinAtar" / "pqn_Breakout-MinAtar_seed0.safetensors"))
    assert saved["CNN_0"]["Dense_0"]["kernel"].dtype == torch.float32
