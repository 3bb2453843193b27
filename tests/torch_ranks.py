"""gloo ranks of the port for the CPU tests of its parallel half.

``run_ranks(name, n, tmp_path, payload)`` starts ``n`` processes of this
file; each joins a gloo group through a file under ``tmp_path`` (no TCP
port: several test workers run at once), runs the scenario ``name`` on
one torch thread, and leaves what it returns in ``tmp_path``. The ranks
import torch and the port only, never JAX: the test module holds their
results against the JAX package in its own process.

    python tests/torch_ranks.py <name> <rank> <n> <dir>
"""

import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

# the tiny ViT of the step scenarios (float32, dims the ranks divide)
TINY_VIT = dict(img_size=16, patch_size=4, num_classes=10, embed_dim=64,
                depth=2, num_heads=2)
STEPS = 3
SGD = dict(lr=0.05, momentum=0.9, weight_decay=1e-4, clip=1.0)
# the seeded resnet18's first gradient has a norm near 200: a small rate
# keeps the second step from amplifying float32 rounding
RESNET_LR = 1e-3
# (name, mesh fsdp extent, weight_update, grad_comm, FSDP rules)
MODES = (("replicated", 1, "replicated", "fp32", False),
         ("zero1", 1, "zero1", "fp32", False),
         ("fsdp", 2, "replicated", "fp32", True),
         ("int8", 1, "replicated", "int8", False),
         ("zero1_int8", 1, "zero1", "int8", False))


def run_ranks(name, n, tmp_path, payload, timeout=300):
    """Run scenario ``name`` on ``n`` gloo ranks; their results, by rank."""
    d = str(tmp_path)
    torch.save(payload, os.path.join(d, f"{name}_in.pt"))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [REPO, HERE, os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), name, str(r), str(n), d],
        env=env, cwd=d, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(n)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {name}:\n{log[-6000:]}"
    return [torch.load(os.path.join(d, f"{name}_out{r}.pt"),
                       weights_only=False) for r in range(n)]


def _np(t):
    return t.detach().cpu().numpy().copy()


# ------------------------------------------------------------ scenarios
def collectives(rank, n, payload, d):
    from deeplearning_tpu_torch.parallel import collectives as coll
    from deeplearning_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    t = {k: torch.from_numpy(v[rank]) for k, v in payload.items()}
    mesh = build_mesh(MeshConfig(data=2, fsdp=2), device="cpu")
    coll.reset_launch_counts()
    out = {
        "psum_ints": coll.quantized_psum(t["ints"], block=16),
        "rs_ints": coll.quantized_reduce_scatter(t["rs_ints"], block=16),
        "tree_ints": coll.quantized_psum_tree(
            {"a": t["ints"], "b": t["ints2"]}, block=16),
        "psum_gauss": coll.quantized_psum(t["gauss_a"]),
        "tree_gauss": coll.quantized_psum_tree(
            {"a": t["gauss_a"], "b": t["gauss_b"]}),
        "rs_gauss": coll.quantized_reduce_scatter(t["gauss_rs"]),
        "fsdp_ints": coll.quantized_psum(t["ints"], mesh.group("fsdp"),
                                         block=16),
        "data_ints": coll.quantized_psum(t["ints"], mesh.group("data"),
                                         block=16),
        "psum_tree": coll.psum_tree({"a": t["ints"], "b": t["gauss_b"]}),
        "pmean_tree": coll.pmean_tree({"a": t["ints"], "b": t["gauss_b"]}),
        "allgather": coll.host_allgather({"r": np.array([rank, 7])}),
        "broadcast": coll.broadcast_from_host0({"rank": rank}),
        "coords": (mesh.coords["data"], mesh.coords["fsdp"],
                   mesh.axis_index(("data", "fsdp"))),
    }
    counts = coll.launch_counts()
    out = coll._map(lambda x: _np(x) if isinstance(x, torch.Tensor)
                    else x, out)
    out["counts"] = counts
    return out


def _vit_state(sd, opt="sgd"):
    from deeplearning_tpu_torch.models.classification.vit import (
        VisionTransformer)
    from deeplearning_tpu_torch.ops.attention import get_attn_fn
    from deeplearning_tpu_torch.train import TrainState
    from deeplearning_tpu_torch.train.optim import build_optimizer
    model = VisionTransformer(**TINY_VIT, dtype=torch.float32,
                              attn_fn=get_attn_fn("naive"))
    model.load_state_dict(sd)
    params = dict(model.named_parameters())
    if opt == "sgd":
        tx = build_optimizer("sgd", SGD["lr"], momentum=SGD["momentum"],
                             weight_decay=SGD["weight_decay"],
                             clip_grad_norm=SGD["clip"], params=params)
    else:
        tx = build_optimizer("adamw", 1e-3, params=params)
    return TrainState.create(model=model, tx=tx)


def _local(batch, rank, n):
    b = batch["image"].shape[0] // n
    return {k: torch.from_numpy(v[rank * b:(rank + 1) * b])
            for k, v in batch.items()}


def _vit_modes(rank, n, payload, d):
    from deeplearning_tpu_torch.parallel import collectives as coll
    from deeplearning_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from deeplearning_tpu_torch.parallel.sharding import (
        FSDP_RULES, shard_layout_summary, tree_bytes_per_device)
    from deeplearning_tpu_torch.train import make_eval_step
    from deeplearning_tpu_torch.train.classification import (
        make_loss_fn, make_metric_fn)
    from deeplearning_tpu_torch.train.steps import (make_train_step,
                                                     shard_state)
    out = {}
    record = {}
    real = coll.quantized_reduce

    def spy(leaves, scatter, group=None, block=256):
        got = real(leaves, scatter, group, block)
        if "local" not in record:
            record["local"] = [_np(x) for x in leaves]
            record["scatter"] = list(scatter)
            record["reduced"] = [_np(x) for x in got]
        return got

    coll.quantized_reduce = spy
    for name, fsdp, wu, comm, fsdp_rules in MODES:
        mesh = build_mesh(MeshConfig(data=n // fsdp, fsdp=fsdp),
                          device="cpu")
        rules = FSDP_RULES if fsdp_rules else None
        state = shard_state(_vit_state(payload["vit"]), mesh, rules,
                            zero1=wu == "zero1")
        step = make_train_step(make_loss_fn(), mesh=mesh, weight_update=wu,
                               grad_comm=comm, rules=rules)
        record.clear()
        coll.reset_launch_counts()
        losses, norms = [], []
        for i in range(STEPS):
            state, m = step(state, _local(payload["batches"][i], rank, n),
                            0)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        counts = coll.launch_counts()
        ev = make_eval_step(make_metric_fn(), mesh=mesh)(
            state, _local(payload["batches"][0], rank, n))
        tree = state.state_dict()
        out[name] = {
            "losses": losses, "grad_norms": norms, "counts": counts,
            "params": {k: _np(v) for k, v in tree["params"].items()},
            "eval": {k: float(v) for k, v in ev.items()},
            "local_params": {k: tuple(p.shape)
                             for k, p in state.params.items()},
            "moment_layout": shard_layout_summary(state.sharding.opt_state),
            "opt_bytes": tree_bytes_per_device(state.opt_state),
            "int8": dict(record)}
    coll.quantized_reduce = real
    # ZeRO-1 moment bytes of an AdamW state, beside replicated
    mesh = build_mesh(MeshConfig(), device="cpu")
    for zero1 in (False, True):
        st = shard_state(_vit_state(payload["vit"], "adamw"), mesh,
                         zero1=zero1)
        out[f"adam_bytes_{zero1}"] = tree_bytes_per_device(st.opt_state)
        out[f"adam_layout_{zero1}"] = shard_layout_summary(
            st.sharding.opt_state)
    return out


def _resnet_step(rank, n, payload):
    from deeplearning_tpu_torch import models  # noqa: F401
    from deeplearning_tpu_torch.core.registry import MODELS
    from deeplearning_tpu_torch.parallel.mesh import build_mesh
    from deeplearning_tpu_torch.train import TrainState
    from deeplearning_tpu_torch.train.classification import make_loss_fn
    from deeplearning_tpu_torch.train.optim import build_optimizer
    from deeplearning_tpu_torch.train.steps import (make_train_step,
                                                     shard_state)
    model = MODELS.build("resnet18", num_classes=10, dtype=torch.float32)
    model.load_state_dict(payload["resnet"])
    tx = build_optimizer("sgd", RESNET_LR, momentum=0.9,
                         params=dict(model.named_parameters()))
    state = TrainState.create(model=model, tx=tx,
                              batch_stats=dict(model.named_buffers()))
    mesh = build_mesh(device="cpu")
    shard_state(state, mesh)
    step = make_train_step(make_loss_fn(has_batch_stats=True), mesh=mesh)
    losses = []
    for i in range(2):
        state, m = step(state, _local(payload["resnet_batches"][i], rank,
                                      n), 0)
        losses.append(float(m["loss"]))
    tree = state.state_dict()
    return {"losses": losses,
            "params": {k: _np(v) for k, v in tree["params"].items()},
            "buffers": {k: _np(v) for k, v in tree["buffers"].items()
                        if "running" in k}}


def _checkpoints(rank, n, payload, d):
    """A ZeRO-1 state after one step saved at dp = n, restored here at
    dp = n, and the gathered moments for the parent to restore at one
    process."""
    from deeplearning_tpu_torch.core.checkpoint import CheckpointManager
    from deeplearning_tpu_torch.elastic.resume import elastic_restore
    from deeplearning_tpu_torch.elastic.topology import (current_topology,
                                                         topology_changed)
    from deeplearning_tpu_torch.parallel.mesh import build_mesh
    from deeplearning_tpu_torch.train.classification import make_loss_fn
    from deeplearning_tpu_torch.train.steps import (make_train_step,
                                                     shard_state)
    mesh = build_mesh(device="cpu")
    state = shard_state(_vit_state(payload["vit"], "adamw"), mesh,
                        zero1=True)
    step = make_train_step(make_loss_fn(), mesh=mesh, weight_update="zero1")
    state, _ = step(state, _local(payload["batches"][0], rank, n), 0)
    ckpt = CheckpointManager(os.path.join(d, "ckpt"))
    topo = current_topology(state=state, weight_update="zero1")
    ckpt.save(1, state, topology=topo)
    saved = state.state_dict()
    local = [_np(t) for t in _leaves(state.opt_state)]
    fresh, got = elastic_restore(ckpt, _vit_state(payload["vit"], "adamw"),
                                 mesh, zero1=True)
    again = [_np(t) for t in _leaves(fresh.opt_state)]
    return {"topology": topo, "sidecar": ckpt.topology(1), "step": got,
            "same_local": all(np.array_equal(a, b)
                              for a, b in zip(local, again)),
            "changed_vs_self": topology_changed(ckpt.topology(1), topo),
            "moments": [_np(t) for t in _leaves(saved["opt_state"])],
            "params": {k: _np(v) for k, v in saved["params"].items()}}


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return []


def _feed_and_eval(rank, n, payload, d):
    from deeplearning_tpu_torch.data.loader import ArraySource, DataLoader
    from deeplearning_tpu_torch.elastic.preempt import agree_preempt_step
    from deeplearning_tpu_torch.evaluation.distributed import (
        gather_and_evaluate)
    loader = DataLoader(ArraySource(**payload["feed"]), global_batch=8,
                        seed=3)
    loader.set_epoch(1)
    batches = [{k: np.asarray(v) for k, v in b.items()} for b in loader]
    coco = gather_and_evaluate(payload["shards"][rank], 3, use_cpp=False)
    return {"batches": batches, "preempt": agree_preempt_step(5 + rank),
            "coco": coco, "host_batch": loader.host_batch}


def _cli(rank, n, payload, d):
    from deeplearning_tpu_torch.train import __main__ as cli
    # the log backends are not under test: without tensorboard (its import
    # pulls TensorFlow, ~10 s) the Trainer's TensorBoard writer is a no-op
    sys.modules["torch.utils.tensorboard"] = None
    workdir = os.path.join(d, "cli")
    rc = cli.main(payload["cli"] + [f"train.workdir={workdir}"])
    with open(os.path.join(workdir, "ckpt", "topology.json")) as f:
        import json
        sidecar = json.load(f)
    return {"rc": rc, "sidecar": sidecar}


def steps(rank, n, payload, d):
    out = {"vit": _vit_modes(rank, n, payload, d),
           "resnet": _resnet_step(rank, n, payload),
           "ckpt": _checkpoints(rank, n, payload, d),
           "feed": _feed_and_eval(rank, n, payload, d)}
    out["cli"] = _cli(rank, n, payload, d)
    return out


# ------------------------------------ sequence and pipeline parallelism
# the tiny ViT of the sequence-parallel steps: N = 9 + 1 = 10 tokens (even:
# the flash paths need N to divide the seq axis), 2 heads (Ulysses)
SP_VIT = dict(img_size=12, patch_size=4, num_classes=10, embed_dim=32,
              depth=2, num_heads=2)
# tests/test_pipeline_train.py's ViT: 4 blocks, 16 wide, 5 tokens
PP_VIT = dict(img_size=16, patch_size=8, num_classes=3, embed_dim=16,
              depth=4, num_heads=2)
# SGD, not Adam, in the comparison: the key bias's gradient is zero in exact
# arithmetic (softmax ignores a shift shared by every key), and Adam would
# scale its round-off up to a full step of either sign
PP_LR = 0.05
# the CLI runs (vit_micro_patch4_56 at 12 px: 10 tokens, 4 heads, 6 blocks)
SP_CLI = ["train.device=cpu", "model.name=vit_micro_patch4_56",
          "model.precision=f32", "data.image_size=12", "data.channels=3",
          "data.n_train=16", "data.global_batch=8", "train.epochs=1"]


def _grads_of(fn, *xs):
    """fn(*xs) and the gradients of sum(fn(*xs) ** 2) w.r.t. xs."""
    xs = [x.clone().requires_grad_() for x in xs]
    out = fn(*xs)
    torch.autograd.backward((out.float() ** 2).sum())
    return _np(out), [_np(x.grad) for x in xs]


def _try(fn):
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def _attention_cases(rank, n, payload):
    """Ring and Ulysses on this rank's chunks, and the attn_fn adapters on
    the replicated (B, N, H, D) inputs."""
    from deeplearning_tpu_torch.ops.flash_attention import flash_attention
    from deeplearning_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from deeplearning_tpu_torch.parallel.ring_attention import (
        make_ring_attention, make_ring_attn_fn, ring_attention)
    from deeplearning_tpu_torch.parallel.ulysses import (
        make_ulysses_attention, make_ulysses_attn_fn, ulysses_attention)
    mesh = build_mesh(MeshConfig(data=1, seq=n), device="cpu")
    group = mesh.group("seq")
    q, k, v = (torch.from_numpy(x) for x in payload["qkv"])
    nl = q.shape[2] // n
    mine = [x[:, :, rank * nl:(rank + 1) * nl] for x in (q, k, v)]
    out = {}
    for name, fn in (
            ("ring", make_ring_attention(mesh)),
            ("ring_flash", make_ring_attention(mesh, use_flash=True)),
            ("ulysses", make_ulysses_attention(mesh)),
            ("ulysses_flash", make_ulysses_attention(
                mesh, attn_fn=flash_attention))):
        out[name] = _grads_of(fn, *mine)
    full = [torch.from_numpy(x) for x in payload["bnhd"]]
    odd = [x[:, :payload["odd_n"]] for x in full]
    for name, fn, xs in (
            ("ring_fn", make_ring_attn_fn(mesh), odd),
            ("ulysses_fn", make_ulysses_attn_fn(mesh), odd),
            ("ring_fn_flash", make_ring_attn_fn(mesh, use_flash=True), full),
            ("ulysses_fn_flash", make_ulysses_attn_fn(mesh, use_flash=True),
             full)):
        out[name] = _grads_of(fn, *xs)
    h6 = [torch.zeros(1, 3 * n // 2 if n > 2 else 3, nl, 8)] * 3
    out["errors"] = {
        "heads": _try(lambda: make_ulysses_attention(mesh)(*h6)),
        "valid_len": _try(lambda: ulysses_attention(
            *mine, group, attn_fn=flash_attention, valid_len=1)),
        "sm_scale": _try(lambda: ulysses_attention(
            *mine, group, sm_scale=0.5, attn_fn=lambda a, b, c: a)),
        "ring_mask": _try(lambda: ring_attention(
            *mine, group, use_flash=True,
            kv_mask=torch.ones(nl, dtype=torch.bool))),
        "flash_pad": _try(lambda: make_ring_attn_fn(mesh, use_flash=True)(
            *odd)),
        "flash_pad_ulysses": _try(lambda: make_ulysses_attn_fn(
            mesh, use_flash=True)(*odd)),
        "dropout": _try(lambda: make_ring_attn_fn(mesh)(
            *odd, dropout_rate=0.1, deterministic=False))}
    return out


def _sp_steps(rank, n, payload):
    """One SGD step of the tiny ViT with each adapter on a data x seq
    mesh (data = n / 2, seq = 2), flash and plain paths."""
    from deeplearning_tpu_torch.models.classification.vit import (
        VisionTransformer)
    from deeplearning_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from deeplearning_tpu_torch.parallel.ring_attention import (
        make_ring_attn_fn)
    from deeplearning_tpu_torch.parallel.sharding import host_local_slice
    from deeplearning_tpu_torch.parallel.ulysses import make_ulysses_attn_fn
    from deeplearning_tpu_torch.train import TrainState
    from deeplearning_tpu_torch.train.classification import make_loss_fn
    from deeplearning_tpu_torch.train.optim import build_optimizer
    from deeplearning_tpu_torch.train.steps import (make_train_step,
                                                     shard_state)
    mesh = build_mesh(MeshConfig(data=n // 2, seq=2), device="cpu")
    lo, hi = host_local_slice(8, mesh)
    batch = {k: torch.from_numpy(v[lo:hi])
             for k, v in payload["sp_batch"].items()}
    out = {"rows": (lo, hi)}
    for name, make in (("ring", make_ring_attn_fn),
                       ("ulysses", make_ulysses_attn_fn)):
        for flash in (False, True):
            model = VisionTransformer(**SP_VIT, dtype=torch.float32,
                                      attn_fn=make(mesh, use_flash=flash))
            model.load_state_dict(payload["sp_vit"])
            tx = build_optimizer("sgd", SGD["lr"], momentum=SGD["momentum"],
                                 params=dict(model.named_parameters()))
            state = shard_state(TrainState.create(model=model, tx=tx), mesh)
            state, m = make_train_step(make_loss_fn(), mesh=mesh)(
                state, batch, 0)
            out[f"{name}_{'flash' if flash else 'plain'}"] = {
                "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                "params": {k: _np(p) for k, p in state.params.items()}}
    return out


def _pipelines(rank, n, payload):
    """pipeline_apply forward and gradients at (S, M) = (n, M) for the
    payload's cases, and the heterogeneous path at S = n."""
    from deeplearning_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from deeplearning_tpu_torch.parallel.pipeline import (
        pipeline_apply, pipeline_apply_heterogeneous)
    mesh = build_mesh(MeshConfig(data=-1, model=n), device="cpu")
    out = {}

    def stage_fn(p, act):
        return torch.tanh(act @ p["w"] + p["b"])

    for m in payload["pp_micro"][n]:
        case = payload[f"pp_{n}_{m}"]
        params = {k: torch.from_numpy(v[rank:rank + 1]).requires_grad_()
                  for k, v in case["params"].items()}
        x = torch.from_numpy(case["x"]).requires_grad_()
        y = pipeline_apply(stage_fn, params, x, mesh)
        (y ** 2).sum().backward()
        out[f"pp_{m}"] = {"y": _np(y), "dx": _np(x.grad),
                          "dparams": {k: _np(p.grad)
                                      for k, p in params.items()}}
    het = payload["het"]
    fns = [lambda p, a: torch.tanh(a @ p["w1"] @ p["w2"]),
           lambda p, a: torch.tanh(a @ p["w"] + p["b"])]
    if n == 2:
        plist = [{k: torch.from_numpy(v).requires_grad_()
                  for k, v in st.items()} for st in het["params"]]
        x = torch.from_numpy(het["x"])
        y = pipeline_apply_heterogeneous(fns, plist, x, mesh)
        (y ** 2).sum().backward()
        out["het"] = {"y": _np(y), "dparams": {
            k: _np(p.grad) for k, p in plist[rank].items()}}
    out["bad_micro"] = _try(lambda: pipeline_apply(
        stage_fn, {k: torch.from_numpy(v[rank:rank + 1])
                   for k, v in payload[f"pp_{n}_{n}"]["params"].items()},
        torch.zeros(n + 1, 2, 8), mesh))
    return out


def _pp_state(payload, n, microbatches=4):
    from deeplearning_tpu_torch.models.classification.vit import (
        VisionTransformer)
    from deeplearning_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from deeplearning_tpu_torch.parallel.pipeline_train import (
        make_pipeline_train_step, shard_pipeline_state, vit_pipeline_module)
    from deeplearning_tpu_torch.train import TrainState
    from deeplearning_tpu_torch.train.optim import build_optimizer
    mesh = build_mesh(MeshConfig(data=-1, model=n), device="cpu")
    vit = VisionTransformer(**PP_VIT, dtype=torch.float32)
    vit.load_state_dict(payload["pp_vit"])
    module, k_per = vit_pipeline_module(vit, n)
    vit.to("meta")
    tx = build_optimizer("sgd", PP_LR, momentum=0.9,
                         params=dict(module.named_parameters()))
    state = shard_pipeline_state(TrainState.create(model=module, tx=tx),
                                 mesh)
    step, eval_step = make_pipeline_train_step(
        vit, mesh, k_per_stage=k_per, microbatches=microbatches)
    return vit, mesh, k_per, state, step, eval_step


def _pipeline_train(rank, n, payload):
    """The pipelined ViT's loss and gradients, then two Adam steps of the
    pipeline train step and its eval counts, at S = n."""
    from deeplearning_tpu_torch.ops import losses
    from deeplearning_tpu_torch.parallel.pipeline_train import (
        make_vit_pipeline_forward)
    vit, mesh, k_per, state, step, eval_step = _pp_state(payload, n)
    batch = {k: torch.from_numpy(v) for k, v in payload["pp_batch"].items()}
    forward = make_vit_pipeline_forward(vit, mesh, k_per, microbatches=4)
    params = state.params
    loss = losses.cross_entropy(forward(params, batch["image"]),
                                batch["label"])
    grads = torch.autograd.grad(loss, list(params.values()))
    out = {"loss": float(loss), "grads": {
        k: _np(g) for k, g in zip(params, grads)}}
    metrics = []
    for _ in range(2):
        state, m = step(state, batch, 0)
        metrics.append({k: float(v) for k, v in m.items()})
    out["metrics"] = metrics
    out["eval"] = {k: int(v) for k, v in eval_step(state, batch).items()}
    out["state"] = {k: _np(v) for k, v in
                    state.state_dict()["params"].items()}
    return out


def _loader_slices(rank, n, payload):
    from deeplearning_tpu_torch.data.loader import ArraySource, DataLoader
    from deeplearning_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    mesh = build_mesh(MeshConfig(data=n // 2, seq=2), device="cpu")
    loader = DataLoader(ArraySource(**payload["feed"]), global_batch=8,
                        seed=3, mesh=mesh)
    loader.set_epoch(1)
    return {"batches": [{k: np.asarray(v) for k, v in b.items()}
                        for b in loader],
            "coords": dict(mesh.coords), "host_batch": loader.host_batch}


def _seq_cli(rank, n, payload, d):
    """The train CLI's Trainer with ring, Ulysses and the pipeline on this
    group; the pipeline run's checkpoint holds the whole stacked state
    and restores into a fresh placed state."""
    from deeplearning_tpu_torch.core import checkpoint
    from deeplearning_tpu_torch.core.config import config_cli
    from deeplearning_tpu_torch.train import __main__ as cli
    sys.modules["torch.utils.tensorboard"] = None
    # a K1 route takes the flash path, which needs N (17) to divide seq
    out = {"flash_odd": _try(lambda: cli.build(config_cli(
        cli.Config(), SP_CLI + ["train.mesh_seq_axis=2",
                                "data.image_size=16"])).train())}
    for name, extra in payload["cli_runs"]:
        workdir = os.path.join(d, f"cli_{name}")
        trainer = cli.build(config_cli(cli.Config(), SP_CLI + extra + [
            f"train.workdir={workdir}"]))
        trainer.train()
        out[name] = {"eval": trainer.evaluate(), "step": trainer.state.step}
        if name == "pipeline":
            ckpt = trainer.ckpt
            ckpt.wait_until_finished()
            step = ckpt.latest_step()
            tree = torch.load(os.path.join(ckpt._step_dir(step),
                                           checkpoint._STATE_FILE),
                              weights_only=True)
            out[name]["shapes"] = {k: tuple(v.shape)
                                   for k, v in tree["params"].items()}
            saved = trainer.state.state_dict()
            fresh = cli.build(config_cli(cli.Config(), SP_CLI + extra))
            ckpt.restore(fresh.state, step)
            again = fresh.state.state_dict()
            out[name]["restored"] = fresh.state.step == step and all(
                torch.equal(again["params"][k], saved["params"][k])
                for k in saved["params"])
            out[name]["vit_devices"] = _live_vit_devices()
    return out


def _live_vit_devices():
    """The devices of every live VisionTransformer's parameters (the
    pipeline's unsplit template keeps none on a device)."""
    import gc
    from deeplearning_tpu_torch.models.classification.vit import (
        VisionTransformer)
    gc.collect()
    return sorted({p.device.type for o in gc.get_objects()
                   if isinstance(o, VisionTransformer)
                   for p in o.parameters()})


def seq_pipe(rank, n, payload, d):
    out = {"attention": _attention_cases(rank, n, payload),
           "sp_steps": _sp_steps(rank, n, payload),
           "pipelines": _pipelines(rank, n, payload),
           "pipeline_train": _pipeline_train(rank, n, payload),
           "loader": _loader_slices(rank, n, payload)}
    if n == 2:
        out["cli"] = _seq_cli(rank, n, payload, d)
    return out


# ------------------------------------------------- tensor parallelism
# JAX's test_3d_parallel_train_step ViT (tests/test_seq_parallel_cli.py):
# 32², patch 8, embed 32, depth 2, 4 heads; N = 16 + 1 = 17 tokens
TP_VIT = dict(img_size=32, patch_size=8, num_classes=4, embed_dim=32,
              depth=2, num_heads=4)
TP_SWIN = dict(patch_size=4, num_classes=4, embed_dim=32, depths=(2, 2),
               num_heads=(2, 4), window=4, img_size=32, drop_path_rate=0.0)
TP_LR = 0.01            # JAX's 3-D test: optax.sgd(0.01)
# fsdp x model in the port's layouts: qkv / fc1 by output over model and
# input over fsdp, proj / fc2 the other way round (JAX's P(fsdp, model) and
# P(model, fsdp) on its (in, out) kernels)
FSDP_TP_RULES = (
    (r"(qkv|mlp/fc1)/kernel$", ("model", "fsdp")),
    (r"(attn/proj|mlp/fc2)/kernel$", ("fsdp", "model")),
    (r"(qkv|mlp/fc1)/bias$", ("model",)),
)
# the CLI's runs: vit_micro_patch4_56 (4 heads, 6 blocks) at 12 px
TP_CLI = SP_CLI + ["train.mesh_model_axis=2"]


def _tp_vit_state(sd, opt="sgd", attn_fn=None, **model_kw):
    from deeplearning_tpu_torch.models.classification.vit import (
        VisionTransformer)
    from deeplearning_tpu_torch.ops.attention import get_attn_fn
    from deeplearning_tpu_torch.train import TrainState
    from deeplearning_tpu_torch.train.optim import build_optimizer
    model = VisionTransformer(**{**TP_VIT, **model_kw}, dtype=torch.float32,
                              attn_fn=attn_fn or get_attn_fn("naive"))
    model.load_state_dict(sd)
    params = dict(model.named_parameters())
    if opt == "sgd":
        tx = build_optimizer("sgd", SGD["lr"], momentum=SGD["momentum"],
                             weight_decay=SGD["weight_decay"],
                             clip_grad_norm=SGD["clip"], params=params)
    elif opt == "sgd0":
        tx = build_optimizer("sgd", TP_LR, momentum=0.0, params=params)
    else:
        tx = build_optimizer("adamw", 1e-3, params=params)
    return TrainState.create(model=model, tx=tx)


def _rules(spec_rules):
    from deeplearning_tpu_torch.parallel.sharding import P
    return tuple((pat, P(*spec)) for pat, spec in spec_rules)


def _named_moments(tree, out=None):
    """{"<moment>/<param name>": array} of every param-keyed moment dict
    (SGD's ``trace``, Adam's ``mu`` / ``nu``) in an optimizer state."""
    out = {} if out is None else out
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k in ("trace", "mu", "nu"):
                out.update({f"{k}/{n}": _np(t) for n, t in v.items()})
            else:
                _named_moments(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _named_moments(v, out)
    return out


def _gathered(state):
    tree = state.state_dict()
    return {"params": {k: _np(v) for k, v in tree["params"].items()},
            "moments": _named_moments(tree["opt_state"])}


def _tp_step(state, mesh, batch, steps=1, **kw):
    from deeplearning_tpu_torch.parallel import collectives as coll
    from deeplearning_tpu_torch.train.classification import make_loss_fn
    from deeplearning_tpu_torch.train.steps import make_train_step
    step = make_train_step(make_loss_fn(), mesh=mesh, **kw)
    coll.reset_launch_counts()
    metrics = []
    for _ in range(steps):
        state, m = step(state, batch, 0)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, {"metrics": metrics, "counts": coll.launch_counts(),
                   **_gathered(state)}


def _tp_batch(payload, mesh):
    from deeplearning_tpu_torch.parallel.sharding import host_local_slice
    lo, hi = host_local_slice(len(payload["tp_batch"]["label"]), mesh)
    return {k: torch.from_numpy(v[lo:hi])
            for k, v in payload["tp_batch"].items()}


def _tp_eval(state, mesh, batch):
    from deeplearning_tpu_torch.train import make_eval_step
    from deeplearning_tpu_torch.train.classification import make_metric_fn
    ev = make_eval_step(make_metric_fn(), mesh=mesh)(state, batch)
    return {k: float(v) for k, v in ev.items()}


def _replicated(state):
    """This rank's copy of every leaf the layout does not split."""
    return {k: _np(p) for k, p in state.params.items()
            if state.sharding.params[k].is_fully_replicated}


def _tp_layouts(rank, n, payload):
    """model = 2: the slices, the gathered leaves, one SGD step and an
    eval, ZeRO-1 (data 1: nothing to split), the masks at drop-path,
    dropout and attention dropout 0.1 against the same mesh without
    rules, Swin through the gather path, and the reduction's refusal of a
    model split."""
    from deeplearning_tpu_torch.models.classification.swin import (
        SwinTransformer)
    from deeplearning_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from deeplearning_tpu_torch.parallel.sharding import (
        TRANSFORMER_TP_RULES, NamedSharding, P, shard_layout_summary,
        tree_bytes_per_device)
    from deeplearning_tpu_torch.train import TrainState
    from deeplearning_tpu_torch.train.optim import build_optimizer
    from deeplearning_tpu_torch.train.steps import _reduce_fp32, shard_state
    rules = TRANSFORMER_TP_RULES
    mesh = build_mesh(MeshConfig(data=1, model=2), device="cpu")
    batch = _tp_batch(payload, mesh)
    st = shard_state(_tp_vit_state(payload["tp_vit"]), mesh, rules)
    out = {"native": sorted(st.sharding.native),
           "slices": {k: _np(p) for k, p in st.params.items()},
           "summary": shard_layout_summary(st.sharding.params),
           "bytes": tree_bytes_per_device(st.params),
           "opt_bytes": tree_bytes_per_device(st.opt_state),
           "groups": {k: m.model_group is not None
                      for k, m in st.model.named_modules()
                      if hasattr(m, "tp_layout")},
           "start": _gathered(st)["params"]}
    st, out["sgd"] = _tp_step(st, mesh, batch, rules=rules)
    out["eval"] = _tp_eval(st, mesh, batch)
    z = shard_state(_tp_vit_state(payload["tp_vit"]), mesh, rules,
                    zero1=True)
    _, out["zero1"] = _tp_step(z, mesh, batch, weight_update="zero1",
                               rules=rules)
    # masks at drop-path, dropout and attention dropout 0.1: two steps with
    # the rules and two on the same mesh without them (both ranks
    # replicate the model)
    for name, r in (("drop_tp", rules), ("drop_rep", None)):
        d = shard_state(_tp_vit_state(payload["tp_vit"], drop_path_rate=0.1,
                                      drop_rate=0.1, attn_drop_rate=0.1),
                        mesh, r)
        d, out[name] = _tp_step(d, mesh, batch, steps=2, rules=r)
        out[name]["replicated"] = _replicated(d)
    # Swin: its window attention's qkv / proj are gathered, its Mlps bound
    for name, r in (("swin_tp", rules), ("swin_rep", None)):
        model = SwinTransformer(**TP_SWIN, dtype=torch.float32)
        model.load_state_dict(payload["tp_swin"])
        tx = build_optimizer("sgd", SGD["lr"], momentum=SGD["momentum"],
                             params=dict(model.named_parameters()))
        sw = shard_state(TrainState.create(model=model, tx=tx), mesh, r)
        native = sorted(sw.sharding.native)
        sw, out[name] = _tp_step(sw, mesh, batch, rules=r)
        out[name]["native"] = native
        out[name]["split"] = shard_layout_summary(sw.sharding.params)
    out["refused"] = _try(lambda: _reduce_fp32(
        {"w": torch.ones(4)}, {"w": NamedSharding(mesh, P("model"))}, mesh))
    return out


def _tp_checkpoints(rank, n, payload, d):
    """A data-parallel AdamW state after one step, saved; restored onto
    data 1 x model 2 under the rules; one step there, saved; restored back
    onto data 2 without rules."""
    from deeplearning_tpu_torch.core.checkpoint import CheckpointManager
    from deeplearning_tpu_torch.elastic.resume import elastic_restore
    from deeplearning_tpu_torch.elastic.topology import current_topology
    from deeplearning_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from deeplearning_tpu_torch.parallel.sharding import TRANSFORMER_TP_RULES
    from deeplearning_tpu_torch.train.steps import shard_state
    dp = build_mesh(MeshConfig(data=2), device="cpu")
    tp = build_mesh(MeshConfig(data=1, model=2), device="cpu")
    st = shard_state(_tp_vit_state(payload["tp_vit"], "adamw"), dp)
    st, _ = _tp_step(st, dp, _tp_batch(payload, dp))
    ck_dp = CheckpointManager(os.path.join(d, "ckpt_dp"))
    ck_dp.save(1, st, topology=current_topology(state=st))
    saved = _gathered(st)
    onto, got = elastic_restore(
        ck_dp, _tp_vit_state(payload["tp_other"], "adamw"), tp,
        rules=TRANSFORMER_TP_RULES)
    out = {"step": got, "saved": saved, "onto_tp": _gathered(onto),
           "tp_qkv": _np(onto.params["blocks.0.attn.qkv.weight"]),
           "tp_qkv_mu": _named_moments(onto.opt_state)[
               "mu/blocks.0.attn.qkv.weight"]}
    onto, out["tp_step"] = _tp_step(onto, tp, _tp_batch(payload, tp))
    ck_tp = CheckpointManager(os.path.join(d, "ckpt_tp"))
    ck_tp.save(2, onto, topology=current_topology(state=onto))
    back, got = elastic_restore(
        ck_tp, _tp_vit_state(payload["tp_other"], "adamw"), dp)
    out["back_step"] = got
    out["back"] = _gathered(back)
    out["sidecar"] = ck_tp.topology(2)
    return out


def _tp_cli(rank, n, payload, d):
    """The train CLI with train.mesh_model_axis=2 over this group."""
    from deeplearning_tpu_torch.core.config import config_cli
    from deeplearning_tpu_torch.train import __main__ as cli
    sys.modules["torch.utils.tensorboard"] = None
    trainer = cli.build(config_cli(cli.Config(), TP_CLI + [
        f"train.workdir={os.path.join(d, 'cli')}"]))
    trainer.train()
    return {"eval": trainer.evaluate(), "step": trainer.state.step,
            "native": sorted(trainer.state.sharding.native),
            "mesh": dict(trainer.state.sharding.mesh.shape)}


def _tp_four(rank, n, payload):
    """data 2 x model 2 (SGD, then ZeRO-1 with SGD's momentum split), and
    fsdp 2 x model 2 with a two-dim spec."""
    from deeplearning_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from deeplearning_tpu_torch.parallel.sharding import (
        TRANSFORMER_TP_RULES, shard_layout_summary, tree_bytes_per_device)
    from deeplearning_tpu_torch.train.steps import shard_state
    rules = TRANSFORMER_TP_RULES
    out = {}
    mesh = build_mesh(MeshConfig(data=2, model=2), device="cpu")
    batch = _tp_batch(payload, mesh)
    st = shard_state(_tp_vit_state(payload["tp_vit"]), mesh, rules)
    st, out["dp_tp"] = _tp_step(st, mesh, batch, rules=rules)
    out["dp_tp"]["eval"] = _tp_eval(st, mesh, batch)
    z = shard_state(_tp_vit_state(payload["tp_vit"]), mesh, rules,
                    zero1=True)
    out["zero1_layout"] = shard_layout_summary(z.sharding.opt_state)
    out["zero1_bytes"] = tree_bytes_per_device(z.opt_state)
    z, out["zero1"] = _tp_step(z, mesh, batch, steps=2,
                               weight_update="zero1", rules=rules)
    mesh = build_mesh(MeshConfig(data=1, fsdp=2, model=2), device="cpu")
    fr = _rules(FSDP_TP_RULES)
    f = shard_state(_tp_vit_state(payload["tp_vit"]), mesh, fr)
    out["fsdp_native"] = sorted(f.sharding.native)
    out["fsdp_qkv"] = tuple(f.params["blocks.0.attn.qkv.weight"].shape)
    f, out["fsdp_tp"] = _tp_step(f, mesh, _tp_batch(payload, mesh),
                                 rules=fr)
    return out


def _tp_three_d(rank, n, payload):
    """JAX's test_3d_parallel_train_step: data 2 x model 2 x seq 2, the
    ring adapter (plain path: 17 tokens padded) and the TP rules, one step
    of SGD at 0.01."""
    from deeplearning_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from deeplearning_tpu_torch.parallel.ring_attention import (
        make_ring_attn_fn)
    from deeplearning_tpu_torch.parallel.sharding import TRANSFORMER_TP_RULES
    from deeplearning_tpu_torch.train.steps import shard_state
    mesh = build_mesh(MeshConfig(data=2, model=2, seq=2), device="cpu")
    st = shard_state(_tp_vit_state(payload["tp_vit"], "sgd0",
                                   attn_fn=make_ring_attn_fn(mesh)),
                     mesh, TRANSFORMER_TP_RULES)
    _, out = _tp_step(st, mesh, _tp_batch(payload, mesh),
                      rules=TRANSFORMER_TP_RULES)
    out["coords"] = dict(mesh.coords)
    # Ulysses splits the rank's 2 local heads over seq = 4: JAX's refusal
    from deeplearning_tpu_torch.parallel.ulysses import make_ulysses_attn_fn
    mesh = build_mesh(MeshConfig(data=1, seq=4, model=2), device="cpu")
    st = shard_state(_tp_vit_state(payload["tp_vit"], "sgd0",
                                   attn_fn=make_ulysses_attn_fn(mesh)),
                     mesh, TRANSFORMER_TP_RULES)
    out["ulysses_heads"] = _try(lambda: _tp_eval(
        st, mesh, _tp_batch(payload, mesh)))
    return out


def tensor_parallel(rank, n, payload, d):
    if n == 2:
        return {"layouts": _tp_layouts(rank, n, payload),
                "ckpt": _tp_checkpoints(rank, n, payload, d),
                "cli": _tp_cli(rank, n, payload, d)}
    if n == 4:
        return _tp_four(rank, n, payload)
    return _tp_three_d(rank, n, payload)


def audits(rank, n, payload, d):
    """The audit's ZeRO-1 rows over this group (one real step each, read
    through collectives.launch_counts()), and the collectives a fake-mode
    walk of a process-group all-reduce and all-gather counts."""
    import torch.distributed as dist

    from deeplearning_tpu_torch.analysis import audit
    rows = audit.run_audits([a for a in audit.builtin_audits("cpu")
                             if a.name.startswith(("train_step_zero1",
                                                   "train_step_replicated"))])
    mode = audit.fake_mode()
    x = audit.fake_tensor(mode, (4, 8))

    def fn(x):
        dist.all_reduce(x)
        out = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(out, x)
    return {"rows": rows, "counts": audit.count_collectives(fn, x),
            "bytes": audit.collective_bytes(fn, x)}


def sync_bn(rank, n, payload, d):
    """utils/normalization.sync_batch_norm_stats over this group, on this
    rank's slice of the batch."""
    from deeplearning_tpu_torch.utils.normalization import (
        sync_batch_norm_stats)
    mean, var = sync_batch_norm_stats(torch.from_numpy(payload["x"][rank]))
    return {"mean": _np(mean), "var": _np(var)}


SCENARIOS = {"collectives": collectives, "steps": steps,
             "seq_pipe": seq_pipe, "tensor_parallel": tensor_parallel,
             "audits": audits, "sync_bn": sync_bn}


def main(name, rank, n, d):
    torch.set_num_threads(1)
    sys.path[:0] = [REPO, HERE]
    from deeplearning_tpu_torch.parallel.mesh import initialize_distributed
    initialize_distributed(f"file://{os.path.join(d, name + '_store')}", n,
                           rank, device="cpu")
    import torch.distributed as dist
    payload = torch.load(os.path.join(d, f"{name}_in.pt"),
                         weights_only=False)
    result = SCENARIOS[name](rank, n, payload, d)
    torch.save(result, os.path.join(d, f"{name}_out{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
