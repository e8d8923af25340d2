"""Toy configurations for the CPU tests: the program's GATE_TOY and CB_TOY
presets as configuration files, added to a copy of the benchmark the way a
later change adds a configuration (files alone)."""

GATE_TOY = {
    "name": "gate_toy", "kind": "gate", "preset": "GATE_TOY",
    "backend": "onthefly", "source": "tfhe_tpu_torch/params.py GATE_TOY",
    "deployment": "CPU tests only", "n": 16, "lwe_stdev_log2": -20,
    "N": 64, "k": 1, "ring_stdev_log2": -25, "l": 3, "bgbit": 7,
    "ks_t": 8, "ks_basebit": 2, "ks_stdev_log2": -20, "key_limbs": 0,
    "control_key_limbs": 3, "assumed": [], "reduced": []}

CB_TOY = {
    "name": "cb_toy", "kind": "circuit", "preset": "CB_TOY",
    "backend": "chunked", "source": "tfhe_tpu_torch/params.py CB_TOY",
    "deployment": "CPU tests only", "n_lvl0": 12, "n_lvl1": 64,
    "n_lvl2": 128, "bgbit_lvl1": 8, "ell_lvl1": 2, "bgbit_lvl2": 9,
    "ell_lvl2": 4, "bk_stdev_log2": -50, "ks_stdev_10_log2": -25,
    "ks_len_10": 6, "ks_basebit_10": 2, "ks_stdev_21_log2": -31,
    "ks_len_21": 10, "ks_basebit_21": 3, "bk_limbs": 0,
    "shared_rotation": False, "input_stdev_log2": -20,
    "control_key_limbs": 6, "assumed": [], "reduced": []}
