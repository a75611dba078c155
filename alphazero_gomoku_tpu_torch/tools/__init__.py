"""Counterparts of the JAX repo's ``tools/``: the tensor-core rate probe
(``matmul_rate``); the arena tools (``compare_snapshots``, ``int8_ab``,
``cross_net_arena``, ``gumbel_ab``, ``reuse_ab``, ``kleaf_ab``,
``harvest_run``, ``strength_probe``) and the mirrored arena of two sides
they play through (``ab_arena``); the probes (``tactics_suites``,
``tactics_probe``, ``distill_net``, ``policy_entropy_probe``,
``int8_calib_sensitivity``, ``tt_rate_probe``); the microbenchmarks
(``tree_kernel_microbench``, ``search_cost_split``, ``hbm_budget``,
``net_microbench``, ``int8_probe``) and their timing on the card
(``card_timing``); the device probes (``device_parity``,
``gumbel_determinism_probe``, ``gumbel_flip_probe``) on the kernels against
their plain versions (``backends``); and the latency floor of the tree
kernels (``latency_floor``), which has no counterpart there."""
