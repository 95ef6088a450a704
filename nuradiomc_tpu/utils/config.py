"""Layered YAML configuration.

Reproduces the reference's config semantics (NuRadioMC/simulation/simulation.py:67-90):
a default config dict deep-merged with a user config, where user values win and
nested dicts merge recursively. The default values mirror
NuRadioMC/simulation/config_default.yaml:1-62.
"""

from __future__ import annotations

import copy
from typing import Any, Mapping

import yaml

from nuradiomc_tpu.utils import units


DEFAULT_CONFIG: dict = {
    "weights": {
        "weight_mode": "core_mantle_crust",
        "cross_section_type": "ctw",
    },
    "noise": False,
    "sampling_rate": 5.0,  # GHz, internal simulation sampling rate
    "seed": 1235,
    # minimal time difference (ns) between signal start times to split an
    # event group into separate events (config_default.yaml:8)
    "split_event_time_diff": 1e6,
    "speedup": {
        "minimum_weight_cut": 1e-5,
        "delta_C_cut": 0.698,  # 40 deg
        "redo_raytracing": False,
        "min_efield_amplitude": 2,
        "amp_per_ray_solution": True,
        "distance_cut": False,
        "distance_cut_coefficients": [-1.56434411e+02, 2.54131322e+01, -1.34932379e+00, 2.39984185e-02],
        "distance_cut_sum_length": 10 * units.m,
    },
    "propagation": {
        "module": "analytic",
        "ice_model": "southpole_2015",
        "attenuation_model": "SP1",
        "attenuate_ice": True,
        "n_freq": 25,
        # batch-solver tuning (not in the reference config): midpoint
        # steps of the attenuation integral and ray-solver iterations; None
        # keeps the PipelineSettings defaults (64 / 96)
        "attenuation_steps": None,
        "attenuation_quadrature": None,   # None -> "gauss"
        "n_bisect": None,
        "focusing_limit": 2,
        "focusing": False,
        "birefringence": False,
        "birefringence_propagation": "analytical",
        "birefringence_model": "southpole_A",
        "angle_to_iceflow": -131,
        "n_reflections": 0,
    },
    "signal": {
        "model": "Alvarez2000",
        "zerosignal": False,
        "polarization": "auto",
        "ePhi": 0.0,
        "shift_for_xmax": False,
    },
    "trigger": {
        "noise_temperature": 300,  # kelvin
        "Vrms": None,
    },
    "save_all": False,
}


def merge_config(user: Mapping[str, Any] | None, default: Mapping[str, Any]) -> dict:
    """Deep-merge ``user`` on top of ``default`` (user wins, dicts recurse)."""
    out = copy.deepcopy(dict(default))
    if user is None:
        return out
    for key, val in user.items():
        if key in out and isinstance(out[key], dict) and isinstance(val, Mapping):
            out[key] = merge_config(val, out[key])
        else:
            out[key] = copy.deepcopy(val)
    return out


def get_config(path_or_dict: str | Mapping[str, Any] | None = None) -> dict:
    """Load a config: a yaml file path or a dict, merged onto the defaults."""
    if path_or_dict is None:
        return merge_config(None, DEFAULT_CONFIG)
    if isinstance(path_or_dict, Mapping):
        return merge_config(path_or_dict, DEFAULT_CONFIG)
    with open(path_or_dict) as f:
        user = yaml.safe_load(f)
    return merge_config(user, DEFAULT_CONFIG)
