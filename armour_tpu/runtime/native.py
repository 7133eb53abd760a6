"""ctypes bindings for the native real-time runtime (native/armour_rt.cpp).

The device owns the planning pipeline; this module is the host-side deployment
path: a microsecond-latency robust CBF controller and plant rollout in C++,
the framework's equivalent of the reference's mex controller
(kinova_robust_controllers_mex/src/kinova_controller.cpp:19-40).  The shared
library is compiled on demand with g++ and cached next to the source; the
math is cross-checked against the JAX twins (controller.py, simulator.py) in
tests/test_native_runtime.py.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "..", "..", "native", "armour_rt.cpp")
_LIB = os.path.join(os.path.dirname(_SRC), "libarmour_rt.so")

_lib = None


def build_library(force: bool = False) -> str:
    """Compile native/armour_rt.cpp to libarmour_rt.so (cached by mtime)."""
    src = os.path.abspath(_SRC)
    lib = os.path.abspath(_LIB)
    if force or not os.path.exists(lib) or os.path.getmtime(lib) < os.path.getmtime(src):
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", src, "-o", lib],
            check=True,
        )
    return lib


class _ArtModel(ctypes.Structure):
    _fields_ = [
        ("num_joints", ctypes.c_int),
        ("num_factors", ctypes.c_int),
        ("axes", ctypes.POINTER(ctypes.c_int)),
        ("trans", ctypes.POINTER(ctypes.c_double)),
        ("rot_mats", ctypes.POINTER(ctypes.c_double)),
        ("mass", ctypes.POINTER(ctypes.c_double)),
        ("com", ctypes.POINTER(ctypes.c_double)),
        ("inertia", ctypes.POINTER(ctypes.c_double)),
        ("armature", ctypes.POINTER(ctypes.c_double)),
        ("damping", ctypes.POINTER(ctypes.c_double)),
        ("gravity", ctypes.c_double),
        ("mass_uncertainty", ctypes.c_double),
        ("inertia_uncertainty", ctypes.c_double),
    ]


def _load():
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(build_library())
        D = ctypes.POINTER(ctypes.c_double)
        _lib.art_rnea.argtypes = [ctypes.POINTER(_ArtModel)] + [D] * 6 + [
            ctypes.c_int, ctypes.c_int, D,
        ]
        _lib.art_robust_control.argtypes = [
            ctypes.POINTER(_ArtModel), ctypes.c_double, ctypes.c_double,
            ctypes.c_double,
        ] + [D] * 8
        _lib.art_rollout.argtypes = [
            ctypes.POINTER(_ArtModel), D, D, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_int,
        ] + [D] * 8
    return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class NativeRuntime:
    """Host-side real-time controller/rollout bound to one RobotModel."""

    def __init__(self, robot, cfg=None):
        _load()
        self.robot = robot
        self.cfg = cfg
        # keep all arrays alive; the C struct borrows their memory
        self._axes = np.ascontiguousarray(robot.axes, dtype=np.int32)
        self._trans = np.ascontiguousarray(robot.trans, dtype=np.float64)
        self._rot_mats = np.ascontiguousarray(robot.rot_mats, dtype=np.float64)
        self._mass = np.ascontiguousarray(robot.mass, dtype=np.float64)
        self._com = np.ascontiguousarray(robot.com, dtype=np.float64)
        self._inertia = np.ascontiguousarray(robot.inertia, dtype=np.float64)
        self._armature = np.ascontiguousarray(robot.armature, dtype=np.float64)
        self._damping = np.ascontiguousarray(robot.damping, dtype=np.float64)
        self._model = _ArtModel(
            num_joints=int(robot.num_joints),
            num_factors=int(robot.num_factors),
            axes=self._axes.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            trans=_ptr(self._trans),
            rot_mats=_ptr(self._rot_mats),
            mass=_ptr(self._mass),
            com=_ptr(self._com),
            inertia=_ptr(self._inertia),
            armature=_ptr(self._armature),
            damping=_ptr(self._damping),
            gravity=float(robot.gravity),
            mass_uncertainty=float(robot.mass_uncertainty),
            inertia_uncertainty=float(robot.inertia_uncertainty),
        )

    @property
    def _ub(self):
        if self.cfg is None:
            raise ValueError("NativeRuntime needs a cfg for controller gains")
        return self.cfg.ub

    def rnea(self, q, qd, qd_aux, qdd, mass=None, inertia=None,
             set_gravity: bool = True, include_armature: bool = True) -> np.ndarray:
        F = self.robot.num_factors
        q, qd, qd_aux, qdd = (
            np.ascontiguousarray(x, dtype=np.float64) for x in (q, qd, qd_aux, qdd)
        )
        m = None if mass is None else np.ascontiguousarray(mass, np.float64)
        I = None if inertia is None else np.ascontiguousarray(inertia, np.float64)
        tau = np.zeros(F)
        _load().art_rnea(
            ctypes.byref(self._model), _ptr(q), _ptr(qd), _ptr(qd_aux),
            _ptr(qdd), _ptr(m) if m is not None else None,
            _ptr(I) if I is not None else None,
            int(set_gravity), int(include_armature), _ptr(tau),
        )
        return tau

    def control(self, q, qd, q_des, qd_des, qdd_des) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """u, tau, v = robust CBF control update (controller.py twin)."""
        ub = self._ub
        F = self.robot.num_factors
        arrs = [np.ascontiguousarray(x, np.float64)
                for x in (q, qd, q_des, qd_des, qdd_des)]
        u, tau, v = np.zeros(F), np.zeros(F), np.zeros(F)
        _load().art_robust_control(
            ctypes.byref(self._model), float(ub.k_r), float(ub.alpha),
            float(ub.v_max), *(_ptr(a) for a in arrs),
            _ptr(u), _ptr(tau), _ptr(v),
        )
        return u, tau, v

    def rollout(self, q0, qd0, q_des, qd_des, qdd_des, true_mass, true_inertia,
                dt: float = 1e-3, substeps: int = 2):
        """Closed-loop rollout under ZOH control at dt; reference arrays are
        [n_steps, F] per control tick.  Returns (q_log, qd_log, u_log)."""
        ub = self._ub
        F = self.robot.num_factors
        q_des = np.ascontiguousarray(q_des, np.float64)
        n = q_des.shape[0]
        qd_des = np.ascontiguousarray(qd_des, np.float64)
        qdd_des = np.ascontiguousarray(qdd_des, np.float64)
        q0 = np.ascontiguousarray(q0, np.float64)
        qd0 = np.ascontiguousarray(qd0, np.float64)
        tm = np.ascontiguousarray(true_mass, np.float64)
        ti = np.ascontiguousarray(true_inertia, np.float64)
        q_log = np.zeros((n, F))
        qd_log = np.zeros((n, F))
        u_log = np.zeros((n, F))
        _load().art_rollout(
            ctypes.byref(self._model), _ptr(tm), _ptr(ti),
            float(ub.k_r), float(ub.alpha), float(ub.v_max),
            float(dt), int(substeps), int(n),
            _ptr(q0), _ptr(qd0), _ptr(q_des), _ptr(qd_des), _ptr(qdd_des),
            _ptr(q_log), _ptr(qd_log), _ptr(u_log),
        )
        return q_log, qd_log, u_log
