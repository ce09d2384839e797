"""Policy rollout / inference tool (port of purejaxql_tpu/scripts/rollout.py):
load a run's saved weights, roll out the greedy policy, report episode
statistics, and optionally save the trajectory (.npz) and render grid
frames as ASCII or an animated GIF.

    python -m purejaxql_torch.scripts.rollout \\
        --run-dir models/CartPole-v1 --episodes 8 --save-traj /tmp/traj.npz
    python -m purejaxql_torch.scripts.rollout \\
        --run-dir models/Breakout-MinAtar --gif /tmp/breakout.gif

A run dir holds ``<run>_config.yaml`` and ``<run>.safetensors`` as either
package's CLI writes them (the first of each, sorted by name: a NUM_SEEDS
run's ``_vmap0``). The episodes run side by side, one env each, for
``--max-steps`` steps (default: the env's episode limit); each episode's
return and length are its first episode's. It runs on the GPU unless
``--device cpu`` is given. The episodes' random draws come from a
generator seeded ``--seed``, so they are not the JAX tool's.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np
import torch

from purejaxql_torch.core.checkpoint import load_params, params_from_flax
from purejaxql_torch.core.config import load_yaml
from purejaxql_torch.envs import make as make_env
from purejaxql_torch.envs import wrappers
from purejaxql_torch.models.factory import make_q_network
from purejaxql_torch.utils.platform import resolve_device


def find_run_files(run_dir: str):
    configs = sorted(glob.glob(os.path.join(run_dir, "*_config.yaml")))
    params_files = sorted(glob.glob(os.path.join(run_dir, "*.safetensors")))
    if not configs or not params_files:
        raise SystemExit(f"No run files in {run_dir} (need *_config.yaml + *.safetensors)")
    return configs[0], params_files[0]


def _load_weights(module: torch.nn.Module, tree) -> None:
    """A saved params tree into ``module``; its batch statistics stay at
    their init values (inference-grade files carry params only)."""
    missing, unexpected = module.load_state_dict(params_from_flax(tree), strict=False)
    buffers = {k for k, _ in module.named_buffers()}
    wrong = sorted(set(missing) - buffers) + sorted(unexpected)
    if wrong:
        raise KeyError(f"the saved params and the network differ in {wrong}")


@torch.no_grad()
def _episodes(env, env_params, policy, num_episodes: int, seed: int, max_steps: int, device):
    """``num_episodes`` Log-wrapped envs side by side for ``max_steps``
    steps: each env's first episode's return and length, and the (obs,
    action, reward) trajectory, (episodes, steps, ...) numpy arrays."""
    gen = torch.Generator(device=device).manual_seed(seed)
    obs, state = env.reset(gen, num_episodes, env_params)
    done_seen = torch.zeros(num_episodes, dtype=torch.bool, device=device)
    ep_ret = torch.zeros(num_episodes, device=device)
    ep_len = torch.zeros(num_episodes, dtype=torch.int32, device=device)
    traj = []
    for _ in range(max_steps):
        action = policy(obs)
        next_obs, state, reward, done, info = env.step(gen, state, action, env_params)
        first_done = done & ~done_seen
        ep_ret = torch.where(first_done, info["returned_episode_returns"].float(), ep_ret)
        ep_len = torch.where(first_done, info["returned_episode_lengths"].to(torch.int32), ep_len)
        done_seen |= done
        traj.append((obs, action, reward))
        obs = next_obs
    trajs = tuple(torch.stack(x, 1).cpu().numpy() for x in zip(*traj))
    return ep_ret.cpu().numpy(), ep_len.cpu().numpy(), trajs


def greedy_rollout(config, params, num_episodes, seed, max_steps, device=None):
    """The argmax policy of a Q-network checkpoint (the MLP on flat or
    flattened observations, or the MinAtar CNN)."""
    device = resolve_device(device)
    env, env_params = make_env(config["ENV_NAME"], **(config.get("ENV_KWARGS") or {}))
    obs_shape = env.observation_space(env_params).shape
    if (len(obs_shape) == 1 or config.get("ARCH") == "mlp") and len(obs_shape) > 1:
        env = wrappers.FlattenObservation(env)
    env = wrappers.Log(env)
    obs_shape = env.observation_space(env_params).shape
    network = make_q_network(config, env.action_space(env_params).n, obs_shape).to(device)
    _load_weights(network, params)
    network.eval()
    return _episodes(env, env_params, lambda obs: network(obs, train=False).argmax(-1), num_episodes, seed,
                     max_steps, device)


def greedy_rollout_ac(config, params, num_episodes, seed, max_steps, device=None):
    """Inference for actor-critic checkpoints: the deterministic tanh actor,
    its actions clipped to the action box, with the saved observation
    statistics (``norm_stats``) replayed frozen where the file holds them."""
    from purejaxql_torch.models.actor_critic import Actor

    device = resolve_device(device)
    env, env_params = make_env(config["ENV_NAME"], **(config.get("ENV_KWARGS") or {}))
    space = env.action_space(env_params)
    low = torch.as_tensor(np.asarray(space.low, np.float32), device=device)
    high = torch.as_tensor(np.asarray(space.high, np.float32), device=device)
    env = wrappers.Log(env)
    actor = Actor(
        env.observation_space(env_params).shape[0], space.shape[0],
        float(((high - low) / 2.0).reshape(-1)[0]), float(((high + low) / 2.0).reshape(-1)[0]),
        config["ACTOR_HIDDEN_SIZES"], activation=config.get("ACTIVATION", "relu"),
        norm_type=config["NORM_TYPE"], init_scale=config.get("ACTOR_INIT_SCALE", 1.0),
    ).to(device)
    _load_weights(actor, params["actor"])
    norm = params.get("norm_stats")
    if norm is not None:
        n_mean, n_var = (torch.as_tensor(np.asarray(norm[k]), dtype=torch.float32, device=device)
                         for k in ("mean", "var"))

    def policy(obs):
        if norm is not None:
            obs = (obs - n_mean) / torch.sqrt(n_var + 1e-8)
        return torch.clamp(actor(obs, train=False), low, high)

    return _episodes(env, env_params, policy, num_episodes, seed, max_steps, device)


def ascii_render_minatar(obs_frame: np.ndarray) -> str:
    """Render a (10, 10, C) MinAtar frame as one character per cell."""
    symbols = "#@*o+x$%"
    grid = [["." for _ in range(obs_frame.shape[1])] for _ in range(obs_frame.shape[0])]
    for c in range(obs_frame.shape[2]):
        for y in range(obs_frame.shape[0]):
            for x in range(obs_frame.shape[1]):
                if obs_frame[y, x, c] > 0.5:
                    grid[y][x] = symbols[c % len(symbols)]
    return "\n".join("".join(row) for row in grid)


def _report(args, rets, lens, trajs) -> None:
    print(f"episodes: {args.episodes}")
    print(f"returns:  mean {rets.mean():.2f}  min {rets.min():.2f}  max {rets.max():.2f}")
    print(f"lengths:  mean {lens.mean():.1f}")
    if args.save_traj:
        np.savez_compressed(args.save_traj, obs=trajs[0], actions=trajs[1], rewards=trajs[2], returns=rets,
                            lengths=lens)
        print(f"trajectory saved to {args.save_traj}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--run-dir", required=True)
    p.add_argument("--episodes", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--save-traj", default=None)
    p.add_argument("--ascii", action="store_true", help="print first-episode frames")
    p.add_argument("--gif", default=None, help="write the first episode as an animated GIF (grid-obs envs only)")
    p.add_argument("--gif-scale", type=int, default=8, help="pixels per grid cell")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    config_path, params_path = find_run_files(args.run_dir)
    config = load_yaml(config_path)
    params = load_params(params_path)
    _, env_params = make_env(config["ENV_NAME"], **(config.get("ENV_KWARGS") or {}))
    max_steps = args.max_steps or getattr(env_params, "max_steps_in_episode", 1000)

    if "actor" in params:
        # actor-critic checkpoint: the deterministic actor with frozen obs-norm replay
        _report(args, *greedy_rollout_ac(config, params, args.episodes, args.seed, max_steps, args.device))
        return 0

    rets, lens, trajs = greedy_rollout(config, params, args.episodes, args.seed, max_steps, args.device)
    _report(args, rets, lens, trajs)

    if args.ascii:
        obs = trajs[0][0]
        for t in range(min(10, obs.shape[0])):
            if obs[t].ndim == 3:
                print(f"--- t={t}")
                print(ascii_render_minatar(obs[t]))

    if args.gif:
        obs = trajs[0][0]  # the first episode, (T, ...)
        if obs.ndim == 2 and config["ENV_NAME"] in ("Forager-v0", "Craftax-Symbolic-v1"):
            # Forager's flat symbolic obs lead with the one-hot local view,
            # VIEW x VIEW x (blocks + mobs): reshape it into grid frames
            from purejaxql_torch.envs.gridworld import forager as _F
            from purejaxql_torch.envs.gridworld import worldgen as _W

            c = _W.NUM_BLOCK_TYPES + _F.NUM_MOB_TYPES
            obs = obs[:, : _F.VIEW * _F.VIEW * c].reshape(obs.shape[0], _F.VIEW, _F.VIEW, c)
        if obs.ndim != 4:
            raise SystemExit(
                "--gif needs (T, H, W, C) grid observations; "
                f"got trajectory obs of shape {obs.shape}. "
                "Train a gridworld/MinAtar checkpoint, or use --save-traj."
            )
        # stop at the first episode boundary so the GIF is one episode
        n_frames = max(int(lens[0]) if lens[0] > 0 else obs.shape[0], 1)
        from purejaxql_torch.utils.gif import render_grid_episode_gif

        render_grid_episode_gif(args.gif, obs[:n_frames], scale=args.gif_scale)
        print(f"gif saved to {args.gif} ({n_frames} frames)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
