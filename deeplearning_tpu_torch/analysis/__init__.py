"""Analysis of the port — the counterpart of ``deeplearning_tpu/analysis``.

- ``strict``: the runtime strict mode (``torch.cuda.set_sync_debug_mode``,
  NaN detection, and the ``threads`` mode that arms the sanitizer).
- ``threadsan``: the runtime thread sanitizer (instrumented locks, the
  lock-order check at acquire and release, the autopsy).
- ``concurrency``: the static lock-order graph the sanitizer is seeded
  from (``lock_order_graph``), over the AST helpers of ``lint``.
- ``audit``: the jaxpr audit's counterpart over fake-mode traces (peak
  intermediate, ops by name, transfers, collectives, the builtin audits).

The linters' rules and the ratchet come with ROADMAP Queue 1 item 8d2.
"""
