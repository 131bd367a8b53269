"""UipcInteractiveScene: cfg-driven scene container for mixed entities.

Counterpart of the reference's ``UipcInteractiveScene`` (reference
source/tacex_uipc/tacex_uipc/envs/uipc_interactive_scene.py:35-658 — a fork
of Isaac Lab's InteractiveScene whose ``_add_entities_from_cfg`` dispatches
each attribute of the scene cfg by type into articulations / rigid objects /
sensors / ``_uipc_objects``, with dict-style access and an ``update()`` that
also refreshes uipc objects :503-524).

Batched shape: entities are declared as a ``{name: cfg}`` dict; the scene
owns one :class:`UipcSim` for every soft/affine body plus per-entity state
pytrees for articulations and rigid primitives. Physics itself stays
functional — the scene is the CONTAINER/lifecycle layer (build, reset,
step-the-soft-solver, lookup), matching the role the reference class plays
around PhysX.
"""

from __future__ import annotations

from typing import Any

import numpy as np

import jax.numpy as jnp

from ..assets.robots import FrankaGelSightCfg
from ..core.config import configclass
from ..physics.rigid import articulation as art
from ..physics.rigid.contact import SphereParams
from ..physics.soft.ipc import RigidSdfScene
from ..sensors.gelsight.sensor import GelSightSensor
from ..sensors.gelsight.sensor_cfg import GelSightSensorCfg
from .objects import UipcObject, UipcObjectCfg
from .sim import UipcSim, UipcSimCfg


@configclass
class RigidObjectCfg:
    """Analytic rigid primitive entity (the stand-in for USD rigid
    props: ball, plate, peg — SURVEY §2.3 Props)."""

    shape: str = "sphere"  # sphere | box | plane
    size: tuple = (0.005,)  # sphere: (radius,); box: half extents; plane: (nx,ny,nz,d)
    init_pos: tuple = (0.0, 0.0, 0.0)
    mass: float = 0.02
    friction: float = 0.9
    kinematic: bool = False


@configclass
class UipcInteractiveSceneCfg:
    """Counterpart of InteractiveSceneCfg: capacity knobs; entities are
    passed to the scene as a dict (our configclass has fixed fields)."""

    num_envs: int = 1
    env_spacing: float = 0.0  # envs are batched, not spatially tiled
    lazy_sensor_update: bool = True
    uipc_sim: UipcSimCfg = None

    def __post_init__(self):
        if self.uipc_sim is None:
            self.uipc_sim = UipcSimCfg()


class _ArticulationEntity:
    """Franka (+gripper) articulation wrapper holding its state pytree."""

    def __init__(self, cfg: FrankaGelSightCfg, num_envs: int):
        self.cfg = cfg
        q0 = jnp.asarray(cfg.default_joint_pos, jnp.float32)
        self.state = art.GripperArmState.init(num_envs, q0_arm=q0)

    def reset(self, num_envs: int) -> None:
        q0 = jnp.asarray(self.cfg.default_joint_pos, jnp.float32)
        self.state = art.GripperArmState.init(num_envs, q0_arm=q0)

    @property
    def joint_pos(self):
        return self.state.q


class _RigidEntity:
    """Analytic rigid primitive with (pos, lin_vel, ang_vel) state."""

    def __init__(self, cfg: RigidObjectCfg, num_envs: int):
        self.cfg = cfg
        # contact params exist only for spheres: SphereParams.inv_inertia
        # divides by r^2, so a radius-0 placeholder for box/plane shapes
        # would hand inf to any consumer (advisor round-2 finding)
        self.params = (
            SphereParams(radius=float(cfg.size[0]), mass=cfg.mass, friction=cfg.friction)
            if cfg.shape == "sphere"
            else None
        )
        self.reset(num_envs)

    def integrate(self, dt: float, gravity, force=None) -> None:
        """Symplectic-Euler free dynamics for a non-kinematic sphere; the
        soft solver's barrier reaction enters through ``force`` (N, 3)."""
        if self.cfg.kinematic or self.cfg.shape != "sphere":
            return
        acc = jnp.asarray(gravity, jnp.float32)
        if force is not None:
            acc = acc + force / self.cfg.mass
        self.lin_vel = self.lin_vel + dt * acc
        self.pos = self.pos + dt * self.lin_vel

    def reset(self, num_envs: int) -> None:
        self.pos = jnp.broadcast_to(
            jnp.asarray(self.cfg.init_pos, jnp.float32), (num_envs, 3)
        )
        self.lin_vel = jnp.zeros((num_envs, 3))
        self.ang_vel = jnp.zeros((num_envs, 3))

    def as_scene_collider(self, scene: RigidSdfScene) -> RigidSdfScene:
        """Append this primitive to a soft-solver collider scene."""
        import dataclasses

        if self.cfg.shape == "sphere":
            sph = jnp.concatenate(
                [self.pos, jnp.full((self.pos.shape[0], 1), self.params.radius)], -1
            )[:, None]
            return dataclasses.replace(
                scene, spheres=jnp.concatenate([scene.spheres, sph], axis=1)
            )
        if self.cfg.shape == "box":
            quat = jnp.broadcast_to(
                jnp.asarray([1.0, 0.0, 0.0, 0.0], jnp.float32), (self.pos.shape[0], 4)
            )
            half = jnp.broadcast_to(
                jnp.asarray(self.cfg.size, jnp.float32), (self.pos.shape[0], 3)
            )
            box = jnp.concatenate([self.pos, quat, half], -1)[:, None]
            return dataclasses.replace(
                scene, boxes=jnp.concatenate([scene.boxes, box], axis=1)
            )
        if self.cfg.shape == "plane":
            pl = jnp.broadcast_to(
                jnp.asarray(self.cfg.size, jnp.float32), (self.pos.shape[0], 1, 4)
            )
            return dataclasses.replace(
                scene, planes=jnp.concatenate([scene.planes, pl], axis=1)
            )
        raise NotImplementedError(self.cfg.shape)


class UipcInteractiveScene:
    """Scene container: build entities from cfgs, dict access, update loop.

    Usage (mirrors reference scene access patterns)::

        scene = UipcInteractiveScene(cfg, entities={
            "robot": FRANKA_PANDA_ARM_SINGLE_GSMINI_UIPC_CFG,
            "gel": UipcObjectCfg(...),
            "ball": RigidObjectCfg(shape="sphere", size=(0.005,)),
            "gsmini": gelsight_mini_cfg(),
        })
        scene.setup()               # uipc world init (reference setup_sim)
        scene["gel"].nodal_pos_w    # entity lookup
        scene.update(colliders)     # advance soft bodies (physics callback)
    """

    def __init__(self, cfg: UipcInteractiveSceneCfg, entities: dict[str, Any]):
        self.cfg = cfg
        n = cfg.num_envs
        self.uipc_sim = UipcSim(
            cfg.uipc_sim if cfg.uipc_sim.num_envs == n
            else cfg.uipc_sim.replace(num_envs=n)
        )
        self._articulations: dict[str, _ArticulationEntity] = {}
        self._rigid_objects: dict[str, _RigidEntity] = {}
        self._uipc_objects: dict[str, UipcObject] = {}
        self._sensors: dict[str, GelSightSensor] = {}
        self._sensor_states: dict[str, Any] = {}
        self._extras: dict[str, Any] = {}
        for name, ecfg in entities.items():
            if isinstance(ecfg, UipcObjectCfg):
                self._uipc_objects[name] = UipcObject(ecfg, self.uipc_sim)
            elif isinstance(ecfg, FrankaGelSightCfg):
                self._articulations[name] = _ArticulationEntity(ecfg, n)
            elif isinstance(ecfg, RigidObjectCfg):
                self._rigid_objects[name] = _RigidEntity(ecfg, n)
            elif isinstance(ecfg, GelSightSensorCfg):
                sensor = GelSightSensor(ecfg, num_envs=n)
                self._sensors[name] = sensor
                self._sensor_states[name] = sensor.init_state()
            else:
                raise ValueError(f"Unknown entity cfg type for {name!r}: {type(ecfg)}")

    # ------------------------------------------------------------- lifecycle
    def setup(self) -> None:
        """Finalize the uipc world (reference: uipc_sim.setup_sim after
        sim.reset, direct_uipc_rl_env.py:139-140)."""
        if self.uipc_sim.objects:
            self.uipc_sim.setup_sim()

    def reset(self) -> None:
        n = self.cfg.num_envs
        for a in self._articulations.values():
            a.reset(n)
        for r in self._rigid_objects.values():
            r.reset(n)
        for obj in self._uipc_objects.values():
            obj.write_vertex_positions_to_sim(jnp.asarray(obj.init_vertex_pos))

    def update(self, colliders: RigidSdfScene | None = None) -> None:
        """Advance the soft world one dt (the physics-callback role,
        reference uipc_sim.py:228-252) against the rigid entities plus any
        extra ``colliders``."""
        scene = colliders if colliders is not None else RigidSdfScene.empty(self.cfg.num_envs)
        sphere_slot: dict[str, int] = {}
        for name, r in self._rigid_objects.items():
            if r.cfg.shape == "sphere":
                sphere_slot[name] = scene.spheres.shape[1]
            scene = r.as_scene_collider(scene)
        if self.uipc_sim.objects:
            self.uipc_sim.step(scene)
        # two-way coupling for dynamic (non-kinematic) spheres: the gel's
        # barrier reaction (action-reaction on the shared potential) plus
        # gravity; kinematic entities stay pure colliders
        dyn = [
            (name, r)
            for name, r in self._rigid_objects.items()
            if r.cfg.shape == "sphere" and not r.cfg.kinematic
        ]
        if dyn:
            forces = None
            sim = self.uipc_sim
            models = []
            if sim._union_model is not None:
                models.append((sim._union_model, sim._union_state))
            else:
                models.extend(
                    (o.model, o.state)
                    for o in sim.objects
                    if o.model is not None and not (o.is_affine_body or o.is_shell)
                )
            for model, state in models:
                f = model.sphere_contact_force(state, scene)  # (N, S, 3)
                forces = f if forces is None else forces + f
            dt, g = sim.cfg.dt, sim.cfg.gravity
            for name, r in dyn:
                f = forces[:, sphere_slot[name]] if forces is not None else None
                r.integrate(dt, g, f)

    # --------------------------------------------------------------- access
    @property
    def articulations(self):
        return self._articulations

    @property
    def rigid_objects(self):
        return self._rigid_objects

    @property
    def uipc_objects(self):
        return self._uipc_objects

    @property
    def sensors(self):
        return self._sensors

    def sensor_state(self, name: str):
        return self._sensor_states[name]

    def set_sensor_state(self, name: str, state) -> None:
        self._sensor_states[name] = state

    def __getitem__(self, key: str):
        """Dict-style entity lookup (reference scene["entity_name"])."""
        for group in (
            self._articulations, self._rigid_objects, self._uipc_objects,
            self._sensors, self._extras,
        ):
            if key in group:
                return group[key]
        raise KeyError(
            f"scene entity {key!r} not found; have "
            f"{sorted([*self._articulations, *self._rigid_objects, *self._uipc_objects, *self._sensors])}"
        )

    def keys(self):
        return (
            list(self._articulations) + list(self._rigid_objects)
            + list(self._uipc_objects) + list(self._sensors)
        )
