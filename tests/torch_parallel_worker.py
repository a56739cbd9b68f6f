"""One rank of the port's multi-rank CPU tests, and the helpers that start them.

The tests write their inputs (weights carried from the JAX package with
``from_flax_params``, batches built from the JAX draws) with ``torch.save``
and start a world of ``gloo`` ranks on the CPU:

    python -m torch.distributed.run --standalone --nproc_per_node N \\
        tests/torch_parallel_worker.py IN.pt OUT_DIR

(or ``... tests/torch_parallel_worker.py --clis PLAN.json OUT_DIR`` for a
plan of the port's CLIs, run one after another in one world). Each rank runs the named scenarios over a ``data`` x ``model`` (or ``pipe``, or ``seq``) mesh and
writes its results to ``OUT_DIR/rank<r>.pt``; the test compares them with
the JAX package. Nothing here imports JAX. Every world runs under a
subprocess timeout (its process group killed when it expires) and every
process group has a 120 s timeout, so a rank that dies cannot hang the
suite.
"""

from __future__ import annotations

import copy
import os
import signal
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT_S = 120


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    env.pop("PYTHONSTARTUP", None)
    return env


def run_torchrun(nproc: int, target, timeout: float = 240, cwd=REPO) -> str:
    """``python -m torch.distributed.run --standalone`` over ``nproc`` ranks
    with ``target`` (a list: a script and its arguments, or ``-m`` and a
    module's); returns the output, raising on a non-zero exit or a timeout
    (after killing the whole world)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc), *target]
    proc = subprocess.Popen(cmd, cwd=cwd, env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"world of {nproc} timed out after {timeout} s:\n{out[-6000:]}")
    if proc.returncode != 0:
        raise AssertionError(f"world of {nproc} exited {proc.returncode}:\n{out[-6000:]}")
    return out


def run_cli_world(nproc: int, plan: list, workdir, timeout: float = 300) -> list:
    """The port's CLIs of ``plan`` (see :func:`run_clis`) one after another in
    one world of ``nproc`` ranks; returns each rank's ``{name: result}``."""
    import json

    workdir = str(workdir)
    path = os.path.join(workdir, "plan.json")
    with open(path, "w") as f:
        json.dump(plan, f)
    run_torchrun(nproc, [os.path.abspath(__file__), "--clis", path, workdir], timeout)
    out = []
    for r in range(nproc):
        with open(os.path.join(workdir, f"cli_rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def run_world(nproc: int, inputs: dict, workdir, timeout: float = 240) -> list:
    """Run this file's scenarios over ``nproc`` ranks (``inputs["scenarios"]``
    maps each name, in order, to its mesh's model size); returns each
    rank's results."""
    workdir = str(workdir)
    path = os.path.join(workdir, "in.pt")
    torch.save(inputs, path)
    run_torchrun(nproc, [os.path.abspath(__file__), path, workdir], timeout)
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
            for r in range(nproc)]


def assert_adamw_matches_one_rank(results, clip: float, tol: dict) -> None:
    """``model_axis_adamw``'s results of every rank: the gradient was clipped
    (its one-rank norm above ``clip``), the model-axis norm is the one-rank
    norm, and after each update the parameters and the whole AdamW moments
    equal the one-rank step's within ``tol``, in the one-rank shapes."""
    import numpy as np

    for res in results:
        for when in ("first", "second"):
            got = res[when]
            assert got["one_norm"] > clip, got["one_norm"]
            np.testing.assert_allclose(got["norm"], got["one_norm"], rtol=1e-5, err_msg=when)
            for name, w in got["one_params"].items():
                np.testing.assert_allclose(got["params"][name].numpy(), w.numpy(),
                                           err_msg=f"{when} {name}", **tol)
            state, want = got["state"], got["one_state"]
            assert (state["updates"], state["mini_step"]) == (want["updates"], want["mini_step"])
            moments, want = state["optimizer"]["state"], want["optimizer"]["state"]
            assert sorted(moments) == sorted(want)
            for key in ("exp_avg", "exp_avg_sq"):
                # relative to the largest moment: a gradient that is zero up to
                # rounding (the attention keys' biases) has moments of noise
                scale = max(float(m[key].abs().max()) for m in want.values())
                for j, m in want.items():
                    a, b = moments[j][key], m[key]
                    assert a.shape == b.shape, (when, j, key, a.shape, b.shape)
                    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=tol["rtol"],
                                               atol=tol["rtol"] * scale,
                                               err_msg=f"{when} slot {j} {key}")


# ---------------------------------------------------------------------------
# scenarios (rank side)
# ---------------------------------------------------------------------------

class SGD:
    """``p -= lr * grad``: optax.sgd, for parity checks where AdamW would
    turn reduction-order noise in near-zero gradients into sign flips."""

    def __init__(self, model, lr: float):
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.lr = lr

    @torch.no_grad()
    def step(self):
        for p in self.params:
            p -= self.lr * p.grad
            p.grad = None


def _model(cls, cfg_kw, state):
    from recformer_tpu_torch.config import RecformerConfig

    cfg = RecformerConfig.tiny(**cfg_kw)
    model = cls(cfg)
    model.load_state_dict(state, strict=True)
    return cfg, model


def _params(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def catalog(mesh, inp):
    """Module 3 over the model group, for each case."""
    from recformer_tpu_torch.parallel.catalog import (shard_rows, sharded_full_softmax_loss,
                                                      sharded_rank, sharded_topk)
    from recformer_tpu_torch.parallel.collectives import gather_list

    g = mesh.model_group
    out = []
    for case in inp["catalog"]:
        pooled, emb, labels = case["pooled"], case["emb"], case["labels"]
        n, temp = emb.shape[0], case["temp"]
        shard = shard_rows(emb, g)
        rank, valid = sharded_rank(pooled, shard, labels, temp, n, g)
        scores, ids = sharded_topk(pooled, shard, case["k"], temp, n, g)
        p = pooled.clone().requires_grad_()
        s = shard.clone().requires_grad_()
        loss = sharded_full_softmax_loss(p, s, labels, temp, n, g)
        loss.backward()
        g_emb = torch.cat(gather_list(s.grad, g))[:n]
        out.append(dict(rank=rank, valid=valid, scores=scores, ids=ids, loss=loss.detach(),
                        g_pooled=p.grad, g_emb=g_emb, n_local=shard.shape[0]))
    return out


def dp_full(mesh, inp):
    """The 'full' data-parallel backward on this rank's rows of the JAX
    global batch, one SGD update."""
    from recformer_tpu_torch.models.heads import RecformerForPretraining
    from recformer_tpu_torch.training.steps import pretrain_backward, take_rows
    from recformer_tpu_torch.utils.rng import StepRNG

    d = inp["dp_full"]
    cfg, model = _model(RecformerForPretraining, d["cfg"], d["state"])
    metrics = pretrain_backward(cfg, model, take_rows(d["batch_a"], mesh),
                                take_rows(d["batch_b"], mesh), StepRNG(0), mesh)
    SGD(model, d["lr"]).step()
    return dict(params=_params(model), loss=metrics["loss"])


def local(mesh, inp):
    """The 'local' backward on this data rank's own batch (the JAX
    per-shard draws), one SGD update."""
    from recformer_tpu_torch.models.heads import RecformerForPretraining
    from recformer_tpu_torch.training.steps import pretrain_backward
    from recformer_tpu_torch.utils.rng import StepRNG

    d = inp["local"]
    cfg, model = _model(RecformerForPretraining, d["cfg"], d["state"])
    batch_a, batch_b = d["batches"][mesh.data_rank]
    metrics = pretrain_backward(cfg, model, batch_a, batch_b, StepRNG(0), mesh)
    SGD(model, d["lr"]).step()
    return dict(params=_params(model), loss=metrics["loss"], cl_total=metrics["cl_total"])


def dp_eval(mesh, inp):
    """The pretraining eval step on this data rank's rows of a global batch
    (the rows each forward saw, and the metrics), and a host flag reduced
    over the mesh's host group, as ``cli.pretrain``'s preemption signal."""
    import torch.distributed as dist

    from recformer_tpu_torch.models.heads import RecformerForPretraining
    from recformer_tpu_torch.parallel.collectives import pmax
    from recformer_tpu_torch.training.steps import make_pretrain_eval_step

    d = inp["dp_eval"]
    cfg, model = _model(RecformerForPretraining, d["cfg"], d["state"])
    rows = []
    model.register_forward_pre_hook(
        lambda mod, args: rows.append(next(iter(args[0].values())).shape[0]))
    step = make_pretrain_eval_step(cfg, model, mesh)
    metrics = step(torch.Generator().manual_seed(d["seed"]), d["table"], d["item_ids"],
                   d["seq_lens"])
    flag = pmax(torch.tensor(3 * mesh.rank), mesh.host_group)
    return dict(metrics=metrics, rows=rows, flag=int(flag),
                host_backend=dist.get_backend(mesh.host_group))


def zero(mesh, inp):
    """Two AdamW steps (dropout on) replicated and under ZeRO from one set
    of weights; then a ZeRO optimizer restored from the replicated one's
    whole state takes a third step beside it. ``eager``: the calls the
    steps' graphs counted as run eagerly (every call under a mesh)."""
    from recformer_tpu_torch.models.heads import RecformerForPretraining
    from recformer_tpu_torch.training.optimizer import create_optimizer
    from recformer_tpu_torch.training.steps import make_pretrain_step
    from recformer_tpu_torch.utils.profiling import counters
    from recformer_tpu_torch.utils.rng import StepRNG, fold_in

    d = inp["zero"]
    table = d["table"]
    kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10, weight_decay=0.01,
              mesh=mesh)
    runs = {}
    for name in ("replicated", "zero", "restored"):
        cfg, model = _model(RecformerForPretraining, d["cfg"], d["state"])
        opt = create_optimizer(model, zero=name != "replicated", **kw)
        runs[name] = (model, opt, make_pretrain_step(cfg, model, opt, mesh))

    def step(name):
        model, opt, fn = runs[name]
        return fn(StepRNG(fold_in(7, opt.micro_steps)), table, d["item_ids"], d["seq_lens"])

    before = counters().get("train_graph.eager", 0)
    for _ in range(2):
        step("replicated")
        step("zero")
    out = {name: dict(params=_params(runs[name][0]), bytes=runs[name][1].state_bytes())
           for name in ("replicated", "zero")}
    out["replicated"]["state"] = runs["replicated"][1].state_dict()
    out["zero"]["state"] = runs["zero"][1].state_dict()
    model, opt, _ = runs["restored"]
    model.load_state_dict(out["replicated"]["params"])
    opt.load_state_dict(copy.deepcopy(out["replicated"]["state"]))
    step("replicated")
    step("restored")
    out["third"] = dict(replicated=_params(runs["replicated"][0]), restored=_params(model))
    out["eager"] = counters().get("train_graph.eager", 0) - before
    out["graphs"] = sum(len(fn.graphs) for _, _, fn in runs.values())
    return out


def dropout_streams(mesh, inp):
    """Under tensor parallelism with dropout on: the head-group seeds, the
    step generator's next draw after them, and the backbone's output, which
    the hidden dropout makes equal across the group only if its masks are."""
    from recformer_tpu_torch.models.heads import RecformerForSeqRec
    from recformer_tpu_torch.parallel.tensor import shard_model_tp
    from recformer_tpu_torch.utils.rng import StepRNG, head_group_rng

    d = inp["dropout_streams"]
    rng = StepRNG(5)
    seed = head_group_rng(rng, mesh.model_rank).seed
    after = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=rng.host))
    _, model = _model(RecformerForSeqRec, d["cfg"], d["state"])
    shard_model_tp(model, mesh)
    pooled = model(d["batch"], deterministic=False, rng=StepRNG(11))
    return dict(seed=seed, after=after, pooled=pooled.detach())


def tensor_parallel(mesh, inp):
    """The dp x tp backward on this rank's rows of the JAX global batch, one
    SGD update, for each config; the whole parameters gathered, the rank's
    replicated ones, and shard-then-gather of the initial weights."""
    from recformer_tpu_torch.models.heads import RecformerForPretraining
    from recformer_tpu_torch.parallel.tensor import (gather_state_dict_tp, shard_model_tp,
                                                     shard_state_dict_tp, tp_split_dim)
    from recformer_tpu_torch.training.steps import pretrain_backward, take_rows
    from recformer_tpu_torch.utils.rng import StepRNG

    out = []
    for d in inp["tensor_parallel"]:
        cfg, model = _model(RecformerForPretraining, d["cfg"], d["state"])
        shard_model_tp(model, mesh)
        own = model.state_dict()
        local_sd = shard_state_dict_tp(d["state"], mesh.model_rank, mesh.n_model)
        regathered = gather_state_dict_tp(own, mesh)
        shard_ok = all(torch.equal(own[k], local_sd[k]) for k in own)
        gather_ok = all(torch.equal(regathered[k], d["state"][k]) for k in d["state"])
        metrics = pretrain_backward(cfg, model, take_rows(d["batch_a"], mesh),
                                    take_rows(d["batch_b"], mesh), StepRNG(0), mesh)
        SGD(model, d["lr"]).step()
        sd = model.state_dict()
        out.append(dict(
            params=gather_state_dict_tp(sd, mesh), loss=metrics["loss"],
            replicated={k: v.clone() for k, v in sd.items() if tp_split_dim(k) is None},
            shard_ok=shard_ok, gather_ok=gather_ok,
            local_heads=model.longformer.encoder.layer[0].attention.self.query.weight.shape[0]
            // cfg.head_dim))
    return out


def sp_attention(mesh, inp):
    """The sequence-parallel op over the mesh's seq group for each case: its
    output, and the gradients of ``sum(out ** 2)`` in q, k, v, k_g and v_g."""
    from recformer_tpu_torch.parallel.sequence import make_sequence_parallel_attention

    out = []
    for case in inp["sp_attention"]:
        xs = [x.clone().requires_grad_() for x in case["inputs"]]
        y = make_sequence_parallel_attention(mesh, case["window"])(*xs, case["mask"])
        (y ** 2).sum().backward()
        out.append(dict(out=y.detach(), grads=[xs[i].grad for i in (0, 1, 2, 4, 5)]))
    return out


def sp_dropout(mesh, inp):
    """The op with attention dropout: two runs from one seed, one from
    another, the mean over many seeds, the clean output, and this rank's
    stream's seed."""
    from recformer_tpu_torch.parallel.sequence import make_sequence_parallel_attention
    from recformer_tpu_torch.utils.rng import StepRNG, head_group_rng

    d = inp["sp_dropout"]
    run = make_sequence_parallel_attention(mesh, d["window"])
    with torch.no_grad():
        clean = run(*d["inputs"], d["mask"])
        a, b, c = (run(*d["inputs"], d["mask"], d["rate"], StepRNG(s)) for s in (7, 7, 8))
        mean = torch.stack([run(*d["inputs"], d["mask"], d["rate"], StepRNG(100 + s))
                            for s in range(d["seeds"])]).mean(0)
    return dict(clean=clean, a=a, b=b, c=c, mean=mean,
                seed=head_group_rng(StepRNG(7), mesh.model_rank).seed)


def sp_backbone(mesh, inp):
    """The sequence-parallel backbone on the JAX weights: deterministic, then
    twice in training mode from one seed and once from another."""
    from recformer_tpu_torch.models.recformer import RecformerModel
    from recformer_tpu_torch.parallel.sequence import make_sequence_parallel_forward
    from recformer_tpu_torch.utils.rng import StepRNG

    d = inp["sp_backbone"]
    _, model = _model(RecformerModel, d["cfg"], d["state"])
    run = make_sequence_parallel_forward(model, mesh)
    with torch.no_grad():
        hidden, pooled = run(d["batch"])
        train = [run(d["batch"], StepRNG(s), deterministic=False)[1] for s in (1, 1, 2)]
    return dict(hidden=hidden, pooled=pooled, train=train)


def _model_axis_step(mesh, d, make):
    """``step.backward`` of a sequence- or pipeline-parallel step on this data
    rank's rows of the JAX global batch, one SGD update."""
    from recformer_tpu_torch.models.heads import RecformerForPretraining
    from recformer_tpu_torch.training.steps import take_rows
    from recformer_tpu_torch.utils.rng import StepRNG

    cfg, model = _model(RecformerForPretraining, d["cfg"], d["state"])
    opt = SGD(model, d["lr"])
    step = make(cfg, model, opt)
    metrics = step.backward(take_rows(d["batch_a"], mesh), take_rows(d["batch_b"], mesh),
                            StepRNG(0))
    opt.step()
    return dict(params=_params(model), loss=metrics["loss"])


def sp_step(mesh, inp):
    from recformer_tpu_torch.parallel.sequence import make_sp_pretrain_step

    return _model_axis_step(mesh, inp["sp_step"],
                            lambda cfg, model, opt: make_sp_pretrain_step(cfg, model, opt, mesh))


def pp_forward(mesh, inp):
    """The pipelined backbone on the JAX weights for each microbatch count,
    and for the first the gradients of ``sum(pooled ** 2)``, each stage's
    own summed over the pipe group (``owned_by_stage``), and in float64 the
    pipelined and the one-rank backbone's."""
    from recformer_tpu_torch.models.recformer import RecformerModel
    from recformer_tpu_torch.parallel.collectives import all_reduce_
    from recformer_tpu_torch.parallel.pipeline import make_pipeline_forward, owned_by_stage

    def grads_of(model, pooled, own=None):
        (pooled ** 2).sum().backward()
        grads = {n: p.grad if own is None or own(n) else torch.zeros_like(p)
                 for n, p in model.named_parameters()}
        if own is not None:
            all_reduce_(list(grads.values()), mesh.model_group)
        return grads

    d = inp["pp_forward"]
    out = []
    for i, M in enumerate(d["microbatches"]):
        cfg, model = _model(RecformerModel, d["cfg"], d["state"])
        hidden, pooled = make_pipeline_forward(model, mesh, M)(d["batch"])
        res = dict(hidden=hidden.detach(), pooled=pooled.detach())
        if i == 0:
            own = owned_by_stage(cfg, mesh.n_model, mesh.model_rank)
            res["grads"] = grads_of(model, pooled, own)
            # the same in float64, pipelined and not: the float32 rounding of
            # the embeddings' small gradients is ~1e-5, above a pipeline fault
            kw = dict(d["cfg"], dtype="float64", param_dtype="float64", attention_impl="chunked")
            state = {k: v.double() for k, v in d["state"].items()}
            cfg, model = _model(RecformerModel, kw, state)
            res["grads64"] = grads_of(model, make_pipeline_forward(model, mesh, M)(d["batch"])[1],
                                      own)
            _, model = _model(RecformerModel, kw, state)
            res["grads64_one_rank"] = grads_of(model, model(**d["batch"])[1])
        out.append(res)
    return out


def pp_step(mesh, inp):
    from recformer_tpu_torch.parallel.pipeline import make_pipeline_pretrain_step

    d = inp["pp_step"]
    return _model_axis_step(mesh, d, lambda cfg, model, opt: make_pipeline_pretrain_step(
        cfg, model, opt, mesh, d["microbatches"]))


def model_axis_remat(mesh, inp):
    """One sequence- or pipeline-parallel step (``inp["kind"]``) with dropout
    on, from one seed, without remat and under each policy: the gradients,
    and the generator's next draw."""
    from recformer_tpu_torch.models.heads import RecformerForPretraining
    from recformer_tpu_torch.parallel.pipeline import make_pipeline_pretrain_step
    from recformer_tpu_torch.parallel.sequence import make_sp_pretrain_step
    from recformer_tpu_torch.training.steps import take_rows
    from recformer_tpu_torch.utils.rng import StepRNG

    d = inp["model_axis_remat"]
    out = {}
    for policy in (None, "full", "save_attention"):
        kw = dict(d["cfg"], remat=policy is not None, remat_policy=policy or "full")
        cfg, model = _model(RecformerForPretraining, kw, d["state"])
        if d["kind"] == "sp":
            step = make_sp_pretrain_step(cfg, model, None, mesh)
        else:
            step = make_pipeline_pretrain_step(cfg, model, None, mesh, 2)
        rng = StepRNG(3)
        step.backward(take_rows(d["batch_a"], mesh), take_rows(d["batch_b"], mesh), rng)
        out[str(policy)] = dict(grads={n: p.grad.clone() for n, p in model.named_parameters()},
                                after=int(torch.randint(0, 2 ** 31 - 1, (1,),
                                                        generator=rng.host)))
    return out


def model_axis_adamw(mesh, inp):
    """Two AdamW updates (``create_optimizer``, the gradient clipped) of a
    sequence- or pipeline-parallel step (``inp["kind"]``) on this data
    rank's rows and of the one-rank step on the whole batch, from one set of
    weights; the second update by a one-rank optimizer restored from the
    model-axis optimizer's whole state (what ``cli.pretrain`` saves in
    ``state.pt``). After each: the global norm each optimizer clips by, the
    parameters and the whole optimizer states."""
    from recformer_tpu_torch.models.heads import RecformerForPretraining
    from recformer_tpu_torch.parallel.pipeline import make_pipeline_pretrain_step
    from recformer_tpu_torch.parallel.sequence import make_sp_pretrain_step
    from recformer_tpu_torch.training.optimizer import create_optimizer
    from recformer_tpu_torch.training.steps import pretrain_backward, take_rows
    from recformer_tpu_torch.utils.rng import StepRNG

    d = inp["model_axis_adamw"]
    kw = dict(learning_rate=1e-3, warmup_steps=0, total_steps=10, weight_decay=0.01,
              grad_clip=d["clip"])
    cfg, model = _model(RecformerForPretraining, d["cfg"], d["state"])
    opt = create_optimizer(model, mesh=mesh, **kw)
    if d["kind"] == "sp":
        step = make_sp_pretrain_step(cfg, model, opt, mesh)
    else:
        step = make_pipeline_pretrain_step(cfg, model, opt, mesh, 2)
    one_cfg, one = _model(RecformerForPretraining, d["one_cfg"], d["state"])
    one_opt = create_optimizer(one, **kw)

    def update(o):
        norm = float(o._global_norm(o._grads()))
        o.step()
        return norm

    def one_step(m, o):
        pretrain_backward(one_cfg, m, d["batch_a"], d["batch_b"], StepRNG(0))
        return update(o)

    step.backward(take_rows(d["batch_a"], mesh), take_rows(d["batch_b"], mesh), StepRNG(0))
    first = dict(norm=update(opt), params=_params(model), state=opt.state_dict(),
                 one_norm=one_step(one, one_opt), one_params=_params(one),
                 one_state=one_opt.state_dict())
    _, restored = _model(RecformerForPretraining, d["one_cfg"], first["params"])
    r_opt = create_optimizer(restored, **kw)
    r_opt.load_state_dict(copy.deepcopy(first["state"]))
    second = dict(norm=one_step(restored, r_opt), params=_params(restored),
                  state=r_opt.state_dict(), one_norm=one_step(one, one_opt),
                  one_params=_params(one), one_state=one_opt.state_dict())
    return dict(first=first, second=second)


SCENARIOS = {f.__name__: f for f in (catalog, dp_full, local, dp_eval, zero, dropout_streams,
                                      tensor_parallel, sp_attention, sp_dropout, sp_backbone,
                                      sp_step, pp_forward, pp_step, model_axis_remat,
                                      model_axis_adamw)}


class SignalAfter(dict):
    """``cli.pretrain``'s preemption flag: at its ``n``-th read (one per step
    boundary) this rank sends itself SIGTERM, which the real handler
    latches before the read returns."""

    def __init__(self, flag, n):
        super().__init__(flag)
        self.flag, self.n, self.reads = flag, n, 0

    def __getitem__(self, key):
        self.reads += 1
        if self.reads == self.n:
            os.kill(os.getpid(), signal.SIGTERM)
        return self.flag[key]


def run_clis(plan_path: str, out_dir: str) -> int:
    """``--clis PLAN.json OUT_DIR``: the port's CLIs of the plan (a JSON list
    of ``{name, module, args, float32, preempt}``) one after another in this
    rank's process, in a world set up here that each CLI joins and leaves
    up: ``float32`` runs the CLI's config in float32 (the CLIs have no dtype
    flag), ``preempt`` ``"R:N"`` sends SIGTERM to rank R at its N-th step
    boundary. Writes each run's result to ``OUT_DIR/cli_rank<r>.json``."""
    import dataclasses
    import importlib
    import json

    from recformer_tpu_torch.parallel.mesh import destroy, init_distributed

    torch.set_num_threads(1)
    init_distributed("cpu", GROUP_TIMEOUT_S)
    rank = int(os.environ["RANK"])
    with open(plan_path) as f:
        plan = json.load(f)
    out = {}
    try:
        for run in plan:
            mod = importlib.import_module(f"recformer_tpu_torch.cli.{run['module']}")
            saved = {k: getattr(mod, k) for k in ("build_config", "_install_preemption_handler")
                     if hasattr(mod, k)}
            if run.get("float32"):
                build = mod.build_config
                mod.build_config = lambda a, item_num=0, _b=build: dataclasses.replace(
                    _b(a, item_num=item_num), dtype="float32")
            if run.get("preempt") and rank == int(run["preempt"].split(":")[0]):
                real = mod._install_preemption_handler
                n = int(run["preempt"].split(":")[1])
                mod._install_preemption_handler = lambda: SignalAfter(real(), n)
            try:
                out[run["name"]] = mod.main(run["args"])
            finally:
                for k, v in saved.items():
                    setattr(mod, k, v)
        with open(os.path.join(out_dir, f"cli_rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        destroy()
    return 0


def main(argv) -> int:
    sys.path.insert(0, REPO)
    if argv[0] == "--clis":
        return run_clis(argv[1], argv[2])
    from recformer_tpu_torch.parallel.mesh import destroy, make_mesh

    torch.set_num_threads(1)
    inp = torch.load(argv[0], weights_only=False)
    meshes = {}
    try:
        results = {}
        for name, spec in inp["scenarios"].items():
            # a mesh spec: the model-axis size, or (size, axis name); a scenario
            # name "fn@tag" runs fn on the inputs under that name
            n_model, axis = spec if isinstance(spec, (tuple, list)) else (spec, "model")
            if (n_model, axis) not in meshes:  # made collectively, in one order on every rank
                meshes[n_model, axis] = make_mesh(n_model, "cpu", timeout_s=GROUP_TIMEOUT_S,
                                                  axis=axis)
            fn = name.split("@")[0]
            results[name] = SCENARIOS[fn](meshes[n_model, axis], dict(inp, **{fn: inp[name]}))
        rank = next(iter(meshes.values())).rank
        torch.save(results, os.path.join(argv[1], f"rank{rank}.pt"))
    finally:
        destroy()
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
