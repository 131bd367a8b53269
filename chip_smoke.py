"""Run the main paths once on one GPU, at the sizes users train at, and
check each against the same code run on the CPU backend of this process.

Usage:
  python chip_smoke.py            # the four one-card phases
  python chip_smoke.py --four     # data-parallel PPO over four cards vs one

Phases (one card):
  flagship_step       4096-env Taxim+FOTS ball-rolling env step
  ppo_train           scripts/train.py's PPO loop on the flagship, 4096 envs
  sensor_320x240      GelSight sensor update at 320x240, shadows off and on
  coupled_grasp_lift  128-env FEM-pad + affine-cube grasp-lift with tactile pads

Each phase prints one JSON line: compile seconds, step milliseconds, the
device's peak bytes in use so far, its comparison errors beside their
limits, and the card as ``nvidia-smi`` names it. The last line is
``{"ok": true, "device": {...}}`` and is printed only when every phase ran
and every comparison held. Without a GPU the script exits 2 before any
phase; a failed comparison exits 1 after the remaining phases have run.

Every comparison starts from one identical state and takes a single step:
contact dynamics amplify last-bit differences over many steps, so a
multi-step comparison would measure chaos, not the port.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import importlib.util
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

import jax
import jax.numpy as jnp

REPO = Path(__file__).resolve().parent
FLAGSHIP = "TacEx-Ball-Rolling-Taxim-Fots-v0"
GRASP = "TacEx-Grasp-Lift-Uipc-Tactile-v0"
ONE_CARD_PHASES = ("flagship_step", "ppo_train", "sensor_320x240", "coupled_grasp_lift")

# Taxim bins surface gradients with floor(), so a last-bit difference can
# move a pixel to the neighbouring LUT row and change its colour by a few
# counts. RGB is therefore bounded by its mean absolute error over all
# pixels and by the share of pixels off by more than 4/255, never by its
# maximum.
RGB_MEAN_ABS = 1.0 / 255
RGB_FAR = 4.0 / 255
RGB_FAR_SHARE = 0.01
# The share is taken over pixels whose surface gradient the input
# determines. On flat gel the eight float32 blurs leave gradients of
# 1e-10..1e-8 (the median pixel at 320x240 is 1.4e-8): their direction,
# and so their LUT row, is arctan2 of rounding noise, which any other
# summation order redraws (the bin-0 rows differ by up to ~13/255). Pixels
# below 1e-4, four orders above that noise, get a share bound of their
# own: on an H100 7-9% of them move by more than 4/255 (the same in every
# run: the optics are deterministic there), and 15% leaves room for
# another card's summation order while still failing an image whose flat
# gel is shaded wrong.
GRAD_FLOOR = 1e-4
RGB_FAR_SHARE_ROUNDING = 0.15
# Proprioception is poses and actions in metres and radians. One env step
# composes IK, a servo and contact over two sim substeps in float32; 1e-4
# is 0.1 mm or 0.1 mrad, far inside what a policy could notice, and three
# orders above float32 rounding of values of order 1.
PROPRIO_RTOL, PROPRIO_ATOL = 1e-3, 1e-4
# FOTS markers are pixel coordinates at 320x240; 0.05 px is a twentieth of
# the resolution the marker image is drawn at.
MARKER_ATOL = 0.05
# The coupled Newton solve is truncated (6 Newton, 24 CG iterations) and
# its line search accepts or rejects steps on last-bit differences, so one
# step amplifies any perturbation to a floor set by the solver, not by the
# perturbation: on the CPU alone, random nudges of the gel coordinates by
# 1e-8 or 1e-7 m (physically nil: barriers act at 1e-3 m) move the gel by
# 1.4-4.6e-5 m, the cube's affine state by 2.0-3.7e-4 and the grip
# estimate by 2.5-12.5e-3 mm in one step, depending on the state. That
# envelope is measured in every run, from the card's own state, with four
# nudges. Rounding on the card perturbs every operation of the step, not
# only its starting state: over three runs on an H100 its errors were
# 0.2-1.9 times the envelope (the card's scatters sum in no fixed order,
# so the state and the readings move between runs). The bound is three
# times the envelope. The same step with its contractions left at TF32
# was off by 1.0e-4 m in the gel: 2-7 times the envelopes above, outside
# the bound in two of those three states.
ENVELOPE_FACTOR = 3.0
GEL_NUDGES_M = (1e-8, 1e-7, 1e-8, 1e-7)
# Data-parallel PPO against one card, as tests/test_multichip.py bounds it:
# the gradient all-reduce sums in another order than one device does.
SHARDED_RTOL, SHARDED_ATOL = 5e-3, 1e-4


# --------------------------------------------------------------- reporting
class CacheCounter:
    """Counts persistent-compilation-cache lookups and hits."""

    def __init__(self):
        self.requests = 0
        self.hits = 0
        jax.monitoring.register_event_listener(self._on_event)

    def _on_event(self, event: str, **_):
        if event == "/jax/compilation_cache/compile_requests_use_cache":
            self.requests += 1
        elif event == "/jax/compilation_cache/cache_hits":
            self.hits += 1


def rgb_errors(got, ref, determined=None) -> dict:
    """Mean absolute error over all pixels; share of pixels off by more
    than RGB_FAR among the ``determined`` ones (N, h, w; default all) and,
    under its own bound, among the rest."""
    d = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    mean_abs = float(d.mean())
    far_px = d.max(axis=-1) > RGB_FAR
    mask = np.ones(far_px.shape, bool) if determined is None else np.asarray(determined)
    far = float(far_px[mask].mean()) if mask.any() else 0.0
    out = {
        "mean_abs": mean_abs, "mean_abs_limit": RGB_MEAN_ABS,
        "share_over_4_255": far, "share_limit": RGB_FAR_SHARE,
        "ok": mean_abs <= RGB_MEAN_ABS and far <= RGB_FAR_SHARE,
    }
    if determined is not None:
        far_rounding = float(far_px[~mask].mean()) if (~mask).any() else 0.0
        out["determined_px"] = float(mask.mean())
        out["share_over_4_255_rounding_px"] = far_rounding
        out["rounding_share_limit"] = RGB_FAR_SHARE_ROUNDING
        out["ok"] = out["ok"] and far_rounding <= RGB_FAR_SHARE_ROUNDING
    return out


def determined_pixels(sensor, height_map):
    """Pixels whose surface gradient on the (reference) sensor is at least
    GRAD_FLOOR: the ones whose shading the input determines."""
    indent = sensor.compute_indentation_depth(height_map)
    grad_mag = jax.jit(sensor.gel_surface)(height_map, indent)[2]
    return np.asarray(grad_mag) >= GRAD_FLOOR


def step_with_height_map(env, state, action):
    """``env.step`` that also returns the height map its sensor computed
    for this step, for the reference's pixel mask. The env's sensor is
    wrapped for the length of the call; its outputs are unchanged."""
    kept = {}
    update = env.sensor.update

    def update_and_keep(*args, **kwargs):
        sensor_state, out = update(*args, **kwargs)
        kept["height_map"] = out["height_map"]
        return sensor_state, out

    env.sensor.update = update_and_keep  # the instance attribute shadows the method
    result = env.step(state, action)
    del env.sensor.update
    return result, kept["height_map"]


def close_errors(got, ref, rtol: float, atol: float) -> dict:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    d = np.abs(got - ref)
    excess = float((d - (atol + rtol * np.abs(ref))).max())
    return {"max_abs": float(d.max()), "rtol": rtol, "atol": atol, "ok": excess <= 0.0}


def envelope_errors(got, ref, nudged, atol: float, per_column: bool = False) -> dict:
    """|got - ref| against ENVELOPE_FACTOR times the reference's own
    response to rounding-level nudges of its input (``nudged``), plus
    ``atol``; per last-axis column when ``per_column``."""
    axes = tuple(range(np.ndim(ref) - 1)) if per_column else None
    ref = np.asarray(ref, np.float64)
    d = np.abs(np.asarray(got, np.float64) - ref).max(axis=axes)
    floor = np.max([np.abs(np.asarray(n, np.float64) - ref).max(axis=axes) for n in nudged], axis=0)
    limit = ENVELOPE_FACTOR * floor + atol
    return {
        "max_abs": np.round(d, 9).tolist(), "cpu_nudge_envelope": np.round(floor, 9).tolist(),
        "limit": np.round(limit, 9).tolist(), "ok": bool(np.all(d <= limit)),
    }


def all_finite(tree) -> bool:
    leaves = [x for x in jax.tree_util.tree_leaves(tree) if jnp.issubdtype(x.dtype, jnp.floating)]
    return all(bool(jnp.isfinite(x).all()) for x in leaves)


def compile_timed(fn, *args):
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    return compiled, time.perf_counter() - t0


def mean_ms(fn, *args, reps: int = 10) -> float:
    """Mean wall time of a compiled call, warm, synchronised."""
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps * 1e3


# ------------------------------------------------------------------ phases
def flagship_actions(num_envs: int, steps: int, action_dim: int, seed: int = 0) -> jax.Array:
    """Seeded random actions with a downward bias so the pad presses the
    ball (as bench.py drives the task)."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-0.3, 0.3, (steps, num_envs, action_dim)).astype(np.float32)
    a[..., 2] -= 0.1
    return jnp.asarray(a)


def phase_flagship_step(cpu, num_envs=4096, steps=20, cmp_envs=16, cmp_warm=20) -> dict:
    from tacex_tpu import envs

    env = envs.make(FLAGSHIP, num_envs=num_envs)
    state, _ = env.reset_all(env.init_state(jax.random.PRNGKey(0)))
    actions = flagship_actions(num_envs, steps + 1, env.cfg.action_space)
    step, compile_s = compile_timed(env.step, state, actions[0])
    state, obs, *_ = step(state, actions[0])
    jax.block_until_ready(obs)
    outs = []
    t0 = time.perf_counter()
    for i in range(steps):
        state, obs, _, _, _, info = step(state, actions[i + 1])
        outs.append((obs, info["indentation_depth"]))
    jax.block_until_ready(outs)
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    finite = all(all_finite(o) for o, _ in outs)
    in_range = all(bool(((o["vision_obs"] >= 0) & (o["vision_obs"] <= 1)).all()) for o, _ in outs)
    contact = max(int((d > 0).sum()) for _, d in outs)
    del outs

    # one step from one state, on the card and on the CPU
    small = envs.make(FLAGSHIP, num_envs=cmp_envs)
    st, _ = small.reset_all(small.init_state(jax.random.PRNGKey(1)))
    acts = flagship_actions(cmp_envs, cmp_warm + 1, small.cfg.action_space, seed=1)
    small_step = jax.jit(small.step)
    for i in range(cmp_warm):
        st, *_ = small_step(st, acts[i])
    _, obs_d, _, _, _, info_d = small_step(st, acts[cmp_warm])
    with jax.default_device(cpu):
        ref_env = envs.make(FLAGSHIP, num_envs=cmp_envs)
        st_c, act_c = jax.device_put((st, acts[cmp_warm]), cpu)
        (_, obs_c, *_), height_map_c = jax.jit(lambda s, a: step_with_height_map(ref_env, s, a))(st_c, act_c)
        determined = determined_pixels(ref_env.sensor, height_map_c)
    return {
        "num_envs": num_envs, "compile_s": compile_s, "step_ms": step_ms,
        "env_steps_per_s": num_envs / step_ms * 1e3,
        "checks": {"obs_finite": finite, "vision_in_0_1": in_range, "envs_in_contact": contact,
                   "ok": finite and in_range and contact > 0},
        "cmp_envs": cmp_envs,
        "cmp_envs_in_contact": int((info_d["indentation_depth"] > 0).sum()),
        "vision_obs": rgb_errors(obs_d["vision_obs"], obs_c["vision_obs"], determined),
        "proprio_obs": close_errors(obs_d["proprio_obs"], obs_c["proprio_obs"], PROPRIO_RTOL, PROPRIO_ATOL),
    }


def _load_train_script():
    spec = importlib.util.spec_from_file_location("tacex_train_script", REPO / "scripts" / "train.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _train_args(num_envs: int, iterations: int, shard: bool = False):
    train = _load_train_script()
    argv = ["--task", FLAGSHIP, "--num_envs", str(num_envs), "--iterations", str(iterations)]
    return train, train.build_parser().parse_args(argv + (["--shard"] if shard else []))


def _train(num_envs: int, iterations: int, shard: bool = False):
    train, args = _train_args(num_envs, iterations, shard)
    return train.run(args)


def phase_ppo_train(num_envs=4096, iterations=3) -> dict:
    from tacex_tpu.rl.agents import agent_cfg_for

    rollouts = agent_cfg_for(FLAGSHIP, "ppo").rollouts
    ts, log = _train(num_envs, iterations)
    losses = [line["loss"] for line in log["iters"]]
    expected = iterations * num_envs * rollouts
    ok = bool(np.isfinite(losses).all()) and int(ts.steps) == expected
    iter_s = [line["iter_s"] for line in log["iters"]]
    return {
        "num_envs": num_envs, "rollouts": rollouts, "compile_s": log["compile_s"],
        "step_ms": float(np.mean(iter_s)) * 1e3,
        "env_steps_per_s": num_envs * rollouts / float(np.mean(iter_s)),
        "checks": {"losses": losses, "steps": int(ts.steps), "expected_steps": expected, "ok": ok},
    }


def sphere_press_depth(num_envs: int, h: int = 240, w: int = 320, shift_mm: float = 0.0, seed: int = 0):
    """Camera depth (N, h, w) in metres of a sphere pressed into the gel:
    per env a seeded centre, radius and press depth."""
    rng = np.random.default_rng(seed)
    cx = w / 2 + rng.uniform(-40, 40, num_envs)
    cy = h / 2 + rng.uniform(-30, 30, num_envs)
    radius = rng.uniform(3.0, 5.0, num_envs)  # mm
    press = rng.uniform(0.5, 1.5, num_envs)  # mm
    mm_per_px = 0.059
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32), indexing="ij")
    dx = (xx[None] - cx[:, None, None]) * mm_per_px - shift_mm
    dy = (yy[None] - cy[:, None, None]) * mm_per_px
    r2 = dx * dx + dy * dy
    R = radius[:, None, None]
    z = np.where(r2 < R * R, R - np.sqrt(np.maximum(R * R - r2, 0.0)), R)  # mm above the lowest point
    gel_top, gel_height = 0.024, 0.0045
    depth = gel_top + gel_height - press[:, None, None] / 1000.0 + z / 1000.0
    return jnp.asarray(depth.astype(np.float32))


def phase_sensor_320x240(cpu, num_envs=256, cmp_n=4, reps=10) -> dict:
    from tacex_tpu.sensors.gelsight.sensor import GelSightSensor
    from tacex_tpu.sensors.gelsight.sensor_cfg import gelsight_mini_cfg
    from tacex_tpu.sensors.gelsight.taxim import optical
    from tacex_tpu.sensors.gelsight.taxim.calib import load_calib

    depth1 = sphere_press_depth(num_envs)
    depth2 = sphere_press_depth(num_envs, shift_mm=0.3)
    yaw1 = jnp.zeros((num_envs,), jnp.float32)
    yaw2 = jnp.full((num_envs,), 0.05, jnp.float32)
    out = {"num_envs": num_envs}
    ok = True
    for with_shadow in (False, True):
        cfg = gelsight_mini_cfg(with_shadow=with_shadow)
        sensor = GelSightSensor(cfg, num_envs=num_envs)
        s0 = sensor.init_state()
        update, compile_s = compile_timed(sensor.update, s0, depth1, yaw1)
        s1, _ = update(s0, depth1, yaw1)
        # second frame from the first one's state: shear and twist engage
        step_ms = mean_ms(update, s1, depth2, yaw2, reps=reps)
        _, o_d = update(s1, depth2, yaw2)
        with jax.default_device(cpu):
            ref = GelSightSensor(cfg, num_envs=cmp_n)
            args_c = jax.device_put(
                (jax.tree_util.tree_map(lambda x: x[:cmp_n], s1), depth2[:cmp_n], yaw2[:cmp_n]), cpu
            )
            _, o_c = jax.jit(ref.update)(*args_c)
            determined = determined_pixels(ref, o_c["height_map"])
        rgb = o_d["tactile_rgb"]
        in_range = bool(((rgb >= 0) & (rgb <= 1)).all()) and all_finite(o_d)
        e_rgb = rgb_errors(rgb[:cmp_n], o_c["tactile_rgb"], determined)
        e_mk = close_errors(o_d["marker_motion"][:cmp_n], o_c["marker_motion"], 0.0, MARKER_ATOL)
        ok &= in_range and e_rgb["ok"] and e_mk["ok"]
        key = "shadow" if with_shadow else "no_shadow"
        out[key] = {
            "compile_s": compile_s, "step_ms": step_ms, "finite_and_in_0_1": in_range,
            "tactile_rgb": e_rgb, "marker_motion": e_mk,
        }

    # the batched shadow pass against the dense per-image oracle, on the card
    calib = load_calib().at_resolution((240, 320))
    hm = jnp.clip(depth2, 0.0, 0.029) * 1000.0
    indent = GelSightSensor(gelsight_mini_cfg(), num_envs=num_envs).compute_indentation_depth(hm)
    deformed, mask = jax.jit(optical.compute_gel_deformation)(calib, optical.shift_height_map(hm, indent))
    deformed_px = deformed / calib.sensor_params.pixmm
    grad_mag, grad_dir = jax.jit(optical.generate_normals)(calib, -deformed_px)
    raw = jax.jit(optical.shade)(calib, grad_mag, grad_dir)
    compact = jax.jit(optical._shadow_pass_compact)(calib, raw[:1], deformed_px[:1], mask[:1], grad_dir[:1])[0]
    dense = jax.jit(optical._shadow_pass_dense)(calib, raw[0], deformed_px[0], mask[0], grad_dir[0])
    bg = calib.background
    e_sh = rgb_errors(jnp.clip(compact + bg, 0, 1), jnp.clip(dense + bg, 0, 1))
    ok &= e_sh["ok"]
    out["shadow_compact_vs_dense"] = e_sh

    # the plain-XLA forms of the optics' two heaviest operations
    shade_fn, _ = compile_timed(lambda m, d: optical.shade(calib, m, d), grad_mag, grad_dir)
    deform_fn, _ = compile_timed(lambda x: optical.compute_gel_deformation(calib, x), hm)
    calib_small = load_calib().at_resolution((24, 32))
    hm_small = jnp.asarray(
        np.random.default_rng(0).uniform(-0.5, 0.5, (4096, 24, 32)).astype(np.float32)
    )
    deform_small, _ = compile_timed(lambda x: optical.compute_gel_deformation(calib_small, x), hm_small)
    out["xla_ms"] = {
        f"shade_{num_envs}x320x240": mean_ms(shade_fn, grad_mag, grad_dir, reps=reps),
        f"deformation_{num_envs}x320x240": mean_ms(deform_fn, hm, reps=reps),
        "deformation_4096x32x24": mean_ms(deform_small, hm_small, reps=reps),
    }
    out["compile_s"] = out["no_shadow"]["compile_s"] + out["shadow"]["compile_s"]
    out["step_ms"] = out["no_shadow"]["step_ms"]
    out["ok"] = ok
    return out


def phase_coupled_grasp_lift(cpu, num_envs=128, steps=10, cmp_envs=8, cmp_warm=5) -> dict:
    from tacex_tpu import envs

    def run(n, k):
        env = envs.make(GRASP, num_envs=n)
        state, _ = env.reset_all(env.init_state(jax.random.PRNGKey(0)))
        close_and_lift = jnp.tile(jnp.array([[1.0, 0.2]], jnp.float32), (n, 1))
        step, compile_s = compile_timed(env.step, state, close_and_lift)
        missed = []
        t0 = time.perf_counter()
        for _ in range(k):
            state, obs, _, _, _, info = step(state, close_and_lift)
            missed.append(info["log"]["Metric/missed_barriers"])
        jax.block_until_ready(state)
        step_ms = (time.perf_counter() - t0) / k * 1e3
        return env, step, state, close_and_lift, compile_s, step_ms, float(sum(missed))

    _, _, state, _, compile_s, step_ms, missed = run(num_envs, steps)
    finite = all_finite(state)

    # one step from one state, on the card and on the CPU; the CPU also
    # steps from the state with every gel coordinate nudged in a random
    # direction, for the solver's own envelope
    _, step_s, st, act, compile_s_small, step_ms_small, _ = run(cmp_envs, cmp_warm)
    st_d, obs_d, *_ = step_s(st, act)
    with jax.default_device(cpu):
        ref_env = envs.make(GRASP, num_envs=cmp_envs)
        ref_step = jax.jit(ref_env.step)
        st_c, act_c = jax.device_put((st, act), cpu)
        st_r, obs_c, *_ = ref_step(st_c, act_c)
        nudged = []
        for seed, size in enumerate(GEL_NUDGES_M):
            signs = np.sign(np.random.default_rng(seed).normal(size=st_c.gel.x.shape)).astype(np.float32)
            gel = dataclasses.replace(st_c.gel, x=st_c.gel.x + size * signs)
            nudged.append(ref_step(dataclasses.replace(st_c, gel=gel), act_c))
    return {
        "num_envs": num_envs, "compile_s": compile_s, "step_ms": step_ms,
        "env_steps_per_s": num_envs / step_ms * 1e3,
        "scaling": {f"{cmp_envs}_envs": {"compile_s": compile_s_small, "step_ms": step_ms_small}},
        "checks": {"state_finite": finite, "missed_barriers": missed, "ok": finite and missed == 0},
        "cmp_envs": cmp_envs,
        "vision_obs": rgb_errors(obs_d["vision_obs"], obs_c["vision_obs"]),
        "proprio_obs": envelope_errors(
            obs_d["proprio_obs"], obs_c["proprio_obs"], [n[1]["proprio_obs"] for n in nudged],
            atol=1e-5, per_column=True,
        ),
        "gel_x": envelope_errors(st_d.gel.x, st_r.gel.x, [n[0].gel.x for n in nudged], atol=1e-7),
        "cube_q": envelope_errors(st_d.cube.q, st_r.cube.q, [n[0].cube.q for n in nudged], atol=1e-6),
    }


def _compile_one_card_in_background(num_envs: int):
    """Lower the one-card PPO step as train.py builds it and compile it on
    a worker thread. Returns a future of the compile seconds. The one-card
    ``train.run`` of the four-card phase then loads the step from the
    persistent compilation cache, so the two compiles overlap."""
    train, args = _train_args(num_envs, 1)
    _, agent, ts = train.setup(args)
    lowered = agent.jit_train_step().lower(ts)

    def compile_timed_s() -> float:
        t0 = time.perf_counter()
        lowered.compile()
        return time.perf_counter() - t0

    pool = ThreadPoolExecutor(1)
    job = pool.submit(compile_timed_s)
    pool.shutdown(wait=False)
    return job


def phase_ppo_four_cards(cache, num_envs=4096, n_cards=4, iterations=3) -> dict:
    """The flagship PPO step data-parallel over ``n_cards`` (train.py
    --shard: ``shard_env_tree`` over ``env_mesh``) against one card, from
    the same seed. The one-card step compiles on a worker thread while the
    sharded run compiles and trains (its iterations may share card 0 with
    that compile), and the sharded run's line is printed before the
    one-card run starts. The first iteration of each run is compared;
    later ones are timed only (the first sharded one includes setting up
    the collectives)."""
    from tacex_tpu.rl.agents import agent_cfg_for

    if len(jax.devices()) != n_cards:
        raise RuntimeError(f"--four needs exactly {n_cards} GPUs, found {len(jax.devices())}")
    hits0 = cache.hits
    one_card_compile = _compile_one_card_in_background(num_envs)
    ts_s, log_s = _train(num_envs, iterations, shard=True)
    placements, device_ids = collections.Counter(), set()
    for leaf in jax.tree_util.tree_leaves(ts_s.env_state):
        if leaf.ndim >= 1 and leaf.shape[0] == num_envs:
            shards = leaf.addressable_shards
            devices = {s.device.id for s in shards}
            device_ids |= devices
            placements[str((len(shards), len(devices), shards[0].data.shape[0]))] += 1
    sharded_ok = set(placements) == {str((n_cards, n_cards, num_envs // n_cards))}
    iter_s = [line["iter_s"] for line in log_s["iters"]]
    sharded = {
        "compile_s": log_s["compile_s"], "iter_s": iter_s,
        "losses": [line["loss"] for line in log_s["iters"]],
        "env_leaves": {"(shards, devices, rows per shard)": dict(placements),
                       "device_ids": sorted(device_ids), "ok": sharded_ok},
        "compile_cache_hits": cache.hits - hits0,
    }
    print(json.dumps({"phase": "ppo_four_cards/sharded", **sharded}), flush=True)

    one_card_compile_s = one_card_compile.result()
    ts_1, log_1 = _train(num_envs, iterations)
    m_s, m_1 = log_s["iters"][0], log_1["iters"][0]
    errs = {
        k: close_errors(m_s[k], m_1[k], SHARDED_RTOL, SHARDED_ATOL) for k in ("loss", "reward_per_step")
    }
    rollouts = agent_cfg_for(FLAGSHIP, "ppo").rollouts
    steps = [int(ts_s.steps), int(ts_1.steps)]
    one_card_iter_s = [line["iter_s"] for line in log_1["iters"]]
    return {
        "num_envs": num_envs, "cards": len(device_ids), "compile_s": log_s["compile_s"], "step_ms": float(np.mean(iter_s[1:])) * 1e3,
        "first_iter_ms": iter_s[0] * 1e3,
        "one_card": {"compile_s": one_card_compile_s, "cache_load_s": log_1["compile_s"], "step_ms": float(np.mean(one_card_iter_s[1:])) * 1e3,
                     "first_iter_ms": one_card_iter_s[0] * 1e3,
                     "losses": [line["loss"] for line in log_1["iters"]]},
        "env_leaves_sharded": sharded["env_leaves"],
        "steps": {"sharded_and_one_card": steps, "ok": steps == [iterations * num_envs * rollouts] * 2},
        **errs,
    }


def phase_ok(result: dict) -> bool:
    """A phase passes when every comparison or check in it holds."""
    oks = []

    def walk(d):
        for k, v in d.items():
            if k == "ok":
                oks.append(bool(v))
            elif isinstance(v, dict):
                walk(v)

    walk(result)
    return bool(oks) and all(oks)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--four", action="store_true", help="data-parallel PPO on four cards against one")
    p.add_argument(
        "--only", action="append", default=[], choices=ONE_CARD_PHASES,
        help="run only this one-card phase (repeatable)",
    )
    args = p.parse_args()

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX's first device is {dev.platform}); nothing was run", file=sys.stderr)
        return 2

    from tacex_tpu import native
    from tacex_tpu.utils.compile_cache import enable_compile_cache
    from tacex_tpu.utils.profiling import gpu_card

    cache_path = enable_compile_cache()
    cache = CacheCounter()
    t0 = time.perf_counter()
    native.build()  # set-up, before any timing
    the_card = gpu_card()
    print(f"card: {the_card}", flush=True)
    print(json.dumps({"setup": {"native_build_s": time.perf_counter() - t0, "compile_cache": cache_path,
                                "jax": jax.__version__}}), flush=True)

    cpu = jax.devices("cpu")[0]
    if args.four:
        phases = {"ppo_four_cards": lambda: phase_ppo_four_cards(cache)}
    else:
        phases = {
            "flagship_step": lambda: phase_flagship_step(cpu),
            "ppo_train": phase_ppo_train,
            "sensor_320x240": lambda: phase_sensor_320x240(cpu),
            "coupled_grasp_lift": lambda: phase_coupled_grasp_lift(cpu),
        }
        if args.only:
            phases = {k: v for k, v in phases.items() if k in args.only}

    all_ok = True
    for name, fn in phases.items():
        hits0, req0 = cache.hits, cache.requests
        result = fn()
        ok = phase_ok(result)
        all_ok &= ok
        line = {
            "phase": name, "ok": ok, **result,
            "compile_cache": {"requests": cache.requests - req0, "hits": cache.hits - hits0},
            "peak_bytes_in_use": dev.memory_stats()["peak_bytes_in_use"],
            "card": the_card,
        }
        print(json.dumps(line), flush=True)

    if not all_ok:
        print("chip_smoke: a comparison or check failed (see the phase lines)", file=sys.stderr)
        return 1
    # the cards the phases ran on: the placement check holds --four to four
    device = {"platform": dev.platform, "kind": dev.device_kind, "count": 4 if args.four else 1}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
