"""Analysis of the port — the counterpart of ``deeplearning_tpu/analysis``.

``strict``: the runtime strict mode (``torch.cuda.set_sync_debug_mode``
and NaN detection). The linters, the jaxpr audit's counterpart and the
thread sanitizer come with ROADMAP Queue 1 item 8c.
"""
