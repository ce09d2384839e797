#!/usr/bin/env python3
"""Count the torch ops of an env's step, raw and through the AC trainer's
wrappers, with torch.profiler on the CPU.

    python scripts/count_env_ops.py Go1JoystickFlatTerrain HumanoidWalk
    python scripts/count_env_ops.py PickPlace-v0 --alg pqn_manipulation --envs 128

Each op a step launches costs the host about the same on the card whatever
the batch, so the count predicts a host-bound step's time there. Counted:
the top-level aten ops of one `step_env` (after one warm-up step) and of one
wrapped `step` (auto-reset, the normalizers, LogVec, ClipAction, ScrubNaN),
views, reshapes and dtype moves left out. Prints one JSON line an env.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# ops that launch no kernel on the card
VIEWS = {"aten::view", "aten::select", "aten::slice", "aten::expand", "aten::unsqueeze", "aten::reshape",
         "aten::as_strided", "aten::alias", "aten::detach", "aten::detach_", "aten::lift_fresh", "aten::to",
         "aten::_to_copy", "aten::empty", "aten::t", "aten::resolve_conj", "aten::resolve_neg"}


def count_ops(fn) -> int:
    from torch.profiler import ProfilerActivity, profile

    fn()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sum(1 for e in prof.events() if e.cpu_parent is None and e.name.startswith("aten::")
               and e.name not in VIEWS)


def main() -> int:
    import torch

    from purejaxql_torch.algo.pqn_ac import build_ac_env
    from purejaxql_torch.core.config import compose
    from purejaxql_torch.envs import make

    ap = argparse.ArgumentParser()
    ap.add_argument("envs", nargs="+")
    ap.add_argument("--alg", default="pqn_locomotion", help="the YAML whose wrappers the wrapped step takes")
    ap.add_argument("--envs", dest="num_envs", type=int, default=128)
    args = ap.parse_args()
    torch.set_num_threads(1)
    for name in args.envs:
        env, params = make(name)
        gen = torch.Generator().manual_seed(0)
        _, state = env.reset(gen, args.num_envs, params)
        action = torch.rand(args.num_envs, *env.action_space(params).shape, generator=gen) * 2 - 1
        draws = env.step_draws(gen, args.num_envs)
        wrapped = build_ac_env(compose(alg=args.alg, overrides=[f"ENV_NAME={name}", "DEVICE=cpu"]))[0]
        _, wstate = wrapped.reset(gen, args.num_envs, params)
        print(json.dumps({"env": name, "envs": args.num_envs, "raw_step_env_ops": count_ops(
            lambda: env.step_env(state, action, params, draws)), "wrapped_step_ops": count_ops(
            lambda: wrapped.step(gen, wstate, action, params)), "wrappers": args.alg}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
