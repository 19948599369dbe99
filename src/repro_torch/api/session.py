"""`CodedSession` of the port — coded training on one device.

PyTorch counterpart of ``repro.api.session.CodedSession`` for training:
the planned HGC code, the per-part data streams, the straggler
simulation + detector feedback, JNCSS replanning, and the train step of
the session's mode:

  * ``"off"``        — single-host reference: λ rides the per-example
    batch weights and the one gradient is the decoded aggregate,
  * ``"coded"``      — the (pod, data) mesh on one card
    (:class:`repro_torch.dist.mesh.OneCardMesh`), or over the ranks of a
    ``torch.distributed`` world (:class:`repro_torch.dist.mesh.DistMesh`,
    with ``tp`` "model" ranks of Megatron tensor parallelism), with the
    two-stage coded decode, λ a runtime operand,
  * ``"coded_int8"`` — same, with the blockwise-int8 + error-feedback
    edge→master hop (per-pod EF residuals ride the session state),
  * ``"coded_q"``    — same hop with the codec ``grad_compression``
    selects (int8 default, int4 packed nibbles, or fp8-e4m3).

Beside training: the checkpoint round trip in the reference's layout
(``checkpoint_dir`` / ``resume``; bit-for-bit kill/resume, and a
reference checkpoint resumes here), ``shrink`` past permanent failures,
``eval_step``, and ``generate`` (``cluster=None`` builds a serve-only
session).  The session runs on the card unless ``device="cpu"`` is
given.

Under tensor parallelism (``tp > 1``, a coded mode) the session is one
rank of a world that the caller set up (``dist.launch.run_ranks``,
``torchrun``, or ``launch.train --tp``, which spawns it): every rank
builds the same session, holds its slices of the params and the state,
and runs the same steps; the mesh's first rank prints and writes
checkpoints, which hold the gathered full arrays (the tp-1 format: they
restore at any degree).  A drop or a replan changes only λ, as at tp 1.
With ``seq_shard=True`` the ranks also split the sequence between the TP
collective pairs (sequence parallelism; ``validate_seq_shard``'s
checks: tp > 1, ``seq_len`` divisible by tp).  With ``pp > 1`` (a coded
mode) the ranks also form a leading "stage" axis of pipeline
parallelism (``launch.steps._pipeline_grads``): each holds its stage's
block of the layer-group stacks, each group's rows run as
``microbatches`` (default ``pp``) microbatches, and ``validate_pp``'s
checks run at construction, on every replan and on shrink.  ``eval_step``
and ``generate`` of a pp > 1 session gather the whole model first.

Where the data ranks are ranks of their own (``data_ranks = data > 1``)
and ``fsdp`` is on (the reference's ``TrainConfig.fsdp`` default), each
rank holds only its FSDP blocks of the params and the optimizer state
(``dist.sharding.data_axes``: the reference's fitted "data" entries);
the step gathers the whole leaves and updates the blocks, and every
reader of whole params (``full_params``, ``eval_step``, ``generate``,
checkpoints, which keep the pp-1/tp-1 whole format) gathers them over
the data group first.  ``shrink`` gathers them over the old data group
before any rank retires and cuts them again for the survivors.  A rank
of a pod-ranks layout holds only its own pod's EF residual row.

Quickstart::

    from repro_torch.api import CodedCluster, CodedSession
    from repro_torch.configs.registry import get_smoke_config

    cluster = CodedCluster.hetero(n_edges=2, n_workers=4)
    session = CodedSession(cluster, get_smoke_config("llama3-8b"),
                           total_steps=20, device="cpu")
    session.fit()
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import _tree, obs
from repro_torch._device import resolve_device
from repro_torch.api import serving
from repro_torch.api.cluster import CodedCluster, sample_straggler_pattern
from repro_torch.api.planner import Planner, get_planner
from repro_torch.checkpoint.params import (
    _flatten,
    _unflatten,
    gather_params,
    leaf_keys,
    params_from_numpy,
    shard_params,
    tensor_from_numpy,
)
from repro_torch.checkpoint.store import CheckpointStore, config_hash
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.hgc import HGCCode
from repro_torch.core.topology import Tolerance
from repro_torch.data.pipeline import TokenStream
from repro_torch.dist.elastic import Plan, price_tolerance
from repro_torch.dist.sharding import (
    NULL_CTX,
    data_axes,
    fsdp_block,
    model_ctx,
    param_axes,
    stage_axes,
    state_axis,
    validate_pp,
    validate_seq_shard,
    validate_tp,
)
from repro_torch.models import transformer as tf
from repro_torch.optim import make_optimizer

PyTree = Any

MODES = ("off", "coded", "coded_int8", "coded_q")


class ReplanError(RuntimeError):
    """A replan or shrink produced a plan the deployed session cannot
    run; the session keeps its previous code.  ``constraint`` names what
    broke (``"uniform_load"``, ``"topology"``, ``"pp"`` (the pipeline's
    divisibility for the new load) or, from :meth:`CodedSession.shrink`,
    ``"plan"``), ``topo`` the surviving topology."""

    def __init__(self, message: str, *, constraint: str, topo):
        super().__init__(message)
        self.constraint = constraint
        self.topo = topo


def _step_rng(seed: int, step: int) -> np.random.Generator:
    """Per-step straggler RNG (history-independent, as the reference's)."""
    return np.random.default_rng(np.random.SeedSequence([seed, 7919, step]))


def _code_desc(code) -> Dict:
    """The checkpointed code descriptor: enough to rebuild the deployed
    code deterministically (grouped codes add their per-edge vector)."""
    d = {"s_e": code.tol.s_e, "s_w": code.tol.s_w, "K": code.K}
    vec = getattr(code.tol, "s_w_vec", None)
    if vec is not None:
        d["s_w_vec"] = [int(s) for s in vec]
    return d


def _serve_only():
    return RuntimeError("serve-only session (cluster=None) cannot train")


def _require_uniform(topo) -> None:
    """The coded modes' (pod, data) mesh needs every edge to hold the
    same number of workers."""
    if len(set(topo.m)) != 1:
        raise ValueError(
            f"dist modes need a uniform topology for the (pod, data) "
            f"mesh, got m={topo.m}")


def build_coded_batch(code: HGCCode, streams, fast_e, fast_w, seq_len,
                      with_lam: bool = True) -> Dict[str, np.ndarray]:
    """Global batch = all workers' assigned-part examples, (pod, data)-major.

    ``with_lam=True`` (mode off): weights carry coeff × λ, stragglers
    weight 0.  ``with_lam=False`` (coded modes): weights carry the coding
    coefficients only; λ is applied in the decode.  ``denom`` is the
    fixed normalizer (K parts × per-part tokens) that keeps the loss
    linear in the weights (exact coded decode).
    """
    lam = code.collapsed_weights(fast_e, fast_w) if with_lam else None
    tokens, targets, weights = [], [], []
    topo = code.topo
    for i in range(topo.n):
        for j in range(topo.m[i]):
            w_idx = topo.flat_index(i, j)
            coeff = code.worker_coeffs(i, j)
            for k in code.assignment.worker_parts(i, j):
                b = streams[k].next_batch()
                tokens.append(b["tokens"])
                targets.append(b["targets"])
                w = b["weights"] * float(coeff[k])
                if lam is not None:
                    w = w * float(lam[w_idx])
                weights.append(w)
    return {
        "tokens": np.concatenate(tokens, 0),
        "targets": np.concatenate(targets, 0),
        "weights": np.concatenate(weights, 0),
        "denom": np.float32(code.K * tokens[0].shape[0] * seq_len),
    }


def _extend_streams(streams, K: int, vocab: int, part_batch: int,
                    seq_len: int, seed: int):
    """K growth reuses the existing part streams; only new parts get
    fresh streams."""
    while len(streams) < K:
        streams.append(TokenStream(vocab, part_batch, seq_len,
                                   seed=seed * 1000 + len(streams)))


class CodedSession:
    """One coded train/serve session over a :class:`CodedCluster`.

    ``cluster=None`` builds a serve-only session (no plan, no data
    streams, no train step).  ``params``: initial weights as a flat
    ``{key: ndarray}`` map in the reference's checkpoint layout
    (``checkpoint.params``) — e.g. the reference session's own initial
    params; None draws them from ``seed`` (the port's initializer, not
    the reference's).  A resumed session takes its weights from the
    checkpoint instead.  ``fsdp`` (``TrainConfig.fsdp``, the reference's
    default) stores the params and the optimizer state as FSDP blocks
    where the data ranks are ranks of their own (no effect elsewhere).
    """

    def __init__(
        self,
        cluster: Optional[CodedCluster],
        cfg: ModelConfig,
        *,
        planner: Any = "jncss",
        mode: str = "off",
        tp: int = 1,
        seq_shard: Optional[bool] = None,
        pp: int = 1,
        microbatches: int = 0,
        seq_len: int = 64,
        part_batch: int = 1,
        K: int = 0,
        optimizer: str = "adamw",
        lr: float = 1e-2,
        total_steps: int = 100,
        warmup_steps: Optional[int] = None,
        grad_clip: float = 1.0,
        grad_block: int = 64,
        grad_compression: str = "",
        seed: int = 0,
        scheme: Optional[str] = None,
        checkpoint_dir: str = "",
        checkpoint_every: int = 25,
        keep_checkpoints: int = 3,
        resume: bool = False,
        log_every: int = 10,
        verbose: bool = True,
        params: Optional[Dict[str, np.ndarray]] = None,
        fsdp: bool = True,
        device="cuda",
    ):
        if mode not in MODES:
            raise ValueError(f"unknown session mode {mode!r}")
        self.pp = max(int(pp), 1)
        self.microbatches = max(int(microbatches), 0)
        if self.microbatches and self.pp <= 1:
            raise ValueError(
                "microbatches requires pp > 1 (the pipeline microbatch "
                "count only applies to the stage pipeline; the "
                "single-host accumulation knob is TrainConfig.microbatch)"
            )
        if self.pp > 1 and cluster is not None:
            if mode == "off":
                raise ValueError(
                    "pp > 1 requires a dist mode (the pipeline runs over "
                    "the 'stage' mesh axis of the coded step)")
            validate_pp(cfg, self.pp)
            if not dist.is_initialized():
                raise RuntimeError(
                    f"pp={self.pp}: the session is one rank of a "
                    f"torch.distributed world; run it in the ranks of "
                    f"repro_torch.dist.launch.run_ranks, under torchrun, "
                    f"or through launch.train --pp (which spawns them)")
        self.tp = max(int(tp), 1)
        #: sequence parallelism of the coded step (the reference's
        #: TrainConfig default, off, unless the caller says)
        self.seq_shard = bool(seq_shard)
        if self.seq_shard and cluster is not None:
            if mode == "off":
                raise ValueError(
                    "--seq-shard requires a dist mode (sequence sharding "
                    "rides the 'model' mesh axis)")
            # tp > 1 and seq_len % tp (+ the recurrent fallback warning)
            validate_seq_shard(cfg, self.tp, seq_len)
        if self.tp > 1:
            if cluster is not None and mode == "off":
                raise ValueError("tp > 1 needs a coded mode (the dist "
                                 "train step); mode 'off' is single-host")
            validate_tp(cfg, self.tp)
            if not dist.is_initialized():
                raise RuntimeError(
                    f"tp={self.tp}: the session is one rank of a "
                    f"torch.distributed world; run it in the ranks of "
                    f"repro_torch.dist.launch.run_ranks, under torchrun, "
                    f"or through launch.train --tp (which spawns them)")
        if mode == "coded_int8":
            if grad_compression and grad_compression != "int8":
                raise ValueError(
                    "mode='coded_int8' pins grad_compression='int8'; use "
                    "mode='coded_q' to pick a codec")
            self.grad_compression = "int8"
        elif mode == "coded_q":
            from repro_torch.dist import compression

            self.grad_compression = grad_compression or "int8"
            if self.grad_compression not in compression.COMPRESSION_MODES:
                raise ValueError(
                    f"unknown grad_compression {self.grad_compression!r} "
                    f"(choose from {compression.COMPRESSION_MODES})")
        else:
            if grad_compression:
                raise ValueError(
                    f"grad_compression={grad_compression!r} needs "
                    f"mode='coded_q' (or 'coded_int8')")
            self.grad_compression = "none"
        self.device = resolve_device(device)
        self.cluster = cluster
        self.cfg = cfg
        self.mode = mode
        self.seq_len = seq_len
        self.part_batch = part_batch
        self.seed = seed
        self.log_every = log_every
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        #: this rank's index on the "model" axis (rank-major layout)
        self.model_rank = self.rank % self.tp
        #: this rank's stage (the leading axis of the rank layout)
        self.stage = 0
        if self.pp > 1 and cluster is not None:
            self.stage = self.rank // (dist.get_world_size() // self.pp)
        else:
            self.pp = 1  # a serve-only session holds the whole model
        self._axes = param_axes(cfg, self.tp)  # flat key → split axis
        self._st_axes = stage_axes(cfg, self.pp)  # flat key → stage axis
        self._verbose = verbose
        self.verbose = verbose and self.rank == 0
        #: the global ranks the session's mesh spans (None: the whole
        #: world); ``shrink`` narrows it to the survivors
        self._ranks = None
        #: set on a rank whose pod or worker ``shrink`` removed
        self._retired = False
        self.losses: List[float] = []
        #: the coded MoE steps' aux losses, of this process's steps
        self.aux_losses: List[float] = []
        self._serve_cache: Dict = {}
        #: the FSDP context over this rank's data group (inactive: the
        #: params and the state are whole over "data") and each param
        #: leaf's "data" dim
        self._data = NULL_CTX
        self._data_axes: Dict[str, Optional[int]] = {}

        if params is not None:
            self.params = params_from_numpy(
                self._my_slices(params), self.device, dtype=torch.float32)
        else:
            # the meta device (the dry run: shapes only) draws nothing
            gen = None if self.device.type == "meta" else \
                torch.Generator(device=self.device).manual_seed(seed)
            self.params = tf.init_params(cfg, gen, device=self.device,
                                         dtype=torch.float32, tp=self.tp,
                                         rank=self.model_rank, pp=self.pp,
                                         stage=self.stage)
        self._ctx = NULL_CTX
        if cluster is None:  # serve-only: no optimizer, no plan
            self.plan = self.code = self.tcfg = None
            self._optimizer = self.opt_state = self.store = None
            self._step = 0
            self._mesh = None
            self._ctx = model_ctx(self.tp)
            return
        for p in _tree.leaves(self.params):
            p.requires_grad_(True)
        self._optimizer = make_optimizer(optimizer)

        # ---- plan the code ------------------------------------------
        self.planner: Planner = get_planner(planner)
        topo = cluster.topo
        K_target = K or self.planner.initial_K(topo)
        self.plan = self.planner.plan(cluster.params, K_target, seed=seed)
        self.code = self.plan.code
        self.scheme = scheme or (
            "hgc_jncss" if self.plan.jncss is not None else "hgc")
        if self.verbose:
            if self.plan.jncss is not None:
                print(f"[train] JNCSS chose (s_e={self.code.tol.s_e}, "
                      f"s_w={self.code.tol.s_w}), D={self.code.load}, "
                      f"K={self.code.K}, "
                      f"T̂={self.plan.expected_iteration_ms:.0f} ms")
            else:
                print(f"[train] fixed scheme {self.scheme}: "
                      f"(s_e={self.code.tol.s_e}, "
                      f"s_w={self.code.tol.s_w}), D={self.code.load}, "
                      f"K={self.code.K}")

        self.tcfg = TrainConfig(
            optimizer=optimizer, lr=lr, total_steps=total_steps,
            warmup_steps=(warmup_steps if warmup_steps is not None
                          else max(total_steps // 10, 1)),
            grad_clip=grad_clip,
            scheme=self.scheme, s_e=self.code.tol.s_e,
            s_w=self.code.tol.s_w, K=self.code.K,
            dist_mode=mode,
            grad_compression=self.grad_compression,
            grad_compression_block=grad_block,
            seq_shard_activations=self.seq_shard,
            pp_stages=self.pp, microbatches=self.microbatches,
            fsdp=bool(fsdp),
        )

        # ---- data: one resumable stream per dataset part -------------
        self.streams: List[TokenStream] = []
        _extend_streams(self.streams, self.code.K, cfg.vocab, part_batch,
                        seq_len, seed)
        # ---- init / resume -------------------------------------------
        self.opt_state = self._optimizer.init(self.params)
        self._step = 0
        self.store = None
        self._restored_extra: Dict = {}
        if checkpoint_dir:
            # hash the MODEL config only: run hyperparameters (total_steps,
            # the LR schedule) legitimately change across restarts
            self.store = CheckpointStore(checkpoint_dir,
                                         keep=keep_checkpoints,
                                         cfg_hash=config_hash(cfg))
            if resume and self.store.latest_step() is not None:
                self._resume()
        self.checkpoint_every = checkpoint_every
        self._setup_train_step()

    # ------------------------------------------------------------------
    # restore
    # ------------------------------------------------------------------
    def _split_axes(self, flat, kind: str = "params"):
        """(the "model" axes, the stage axes, the FSDP "data" axes) of
        ``flat``'s keys: the params', an optimizer state's (``kind=
        "state"``: ``state_axis`` of the params') or the EF residual's
        (``"residual"``: the params' model and stage axes, whole over
        "data")."""
        if kind == "params":
            return self._axes, self._st_axes, self._data_axes
        if kind == "residual":
            return self._axes, self._st_axes, {}
        return tuple({k: state_axis(k, a) for k in flat}
                     for a in (self._axes, self._st_axes, self._data_axes))

    def _my_slices(self, flat, kind: str = "params"):
        """This rank's slices of full flat-key arrays: the "model" axis
        (tp), then the stage's block (pp); whole over "data" (the train
        step's setup cuts the FSDP blocks)."""
        axes, st, _ = self._split_axes(flat, kind)
        return shard_params(flat, self.cfg, self.tp, self.model_rank, axes,
                            pp=self.pp, stage=self.stage, stage_axes=st)

    def _data_map(self, tree, kind: str, fn):
        """``tree`` (the params or the optimizer state) with ``fn(leaf,
        its "data" dim)`` in place of each leaf the FSDP layout splits."""
        flat = _flatten(tree)
        axes = self._split_axes(flat, kind)[2]
        return _unflatten({k: v if axes.get(k) is None else fn(v, axes[k])
                           for k, v in flat.items()})

    def _slice_data(self, data) -> None:
        """Cut the params and the optimizer state, whole over "data", to
        this rank's FSDP blocks over ``data`` (an inactive context: leave
        them whole)."""
        if not data.active:
            return
        self._data, self._data_axes = data, data_axes(self.cfg, data.tp)

        def cut(v, ax):
            return fsdp_block(v.detach(), ax, data).clone()

        self.params = self._data_map(self.params, "params", cut)
        self.opt_state = self._data_map(self.opt_state, "state", cut)
        for p in _tree.leaves(self.params):
            p.requires_grad_(True)

    def _whole_over_data(self, tree, kind: str = "params"):
        """``tree``'s leaves whole over "data" (gathered from every data
        rank's block: collective), as new tensors."""
        return self._data_map(
            tree, kind, lambda v, ax: self._data.gather(v.detach(), ax))

    def _unslice_data(self) -> None:
        """The params and the optimizer state whole over "data" again
        (collective over the data group)."""
        if not self._data.active:
            return
        self.params = self._whole_over_data(self.params)
        self.opt_state = self._whole_over_data(self.opt_state, "state")
        for p in _tree.leaves(self.params):
            p.requires_grad_(True)
        self._data, self._data_axes = NULL_CTX, {}

    def _resume(self):
        start, state, extra = self.store.restore()
        self._restored_extra = extra
        # the file holds full arrays: under TP and PP each rank keeps its
        # slices
        self.params = params_from_numpy(
            self._my_slices(_flatten(state["params"])), self.device,
            dtype=torch.float32)
        for p in _tree.leaves(self.params):
            p.requires_grad_(True)
        if "opt_state" in state:
            # stateless optimizers (sgd) flatten to an empty subtree: the
            # freshly initialized state is already right then
            flat = {k: tensor_from_numpy(a, self.device) for k, a in
                    self._my_slices(_flatten(state["opt_state"]),
                                    "state").items()}
            self.opt_state = _unflatten(flat)
        del state
        cl = extra.get("cluster")
        if cl and (cl.get("dead_edges") or cl.get("dead_workers")):
            # the run had shrunk past permanent failures before the kill
            self.cluster = self.cluster.restored(cl)
            if self.verbose:
                print(f"[train] restored shrunk topology "
                      f"m={self.cluster.topo.m}")
        ck = extra.get("code")
        if ck and (ck != _code_desc(self.code)
                   or self.code.topo != self.cluster.topo):
            # the run had replanned before the kill: rebuild the deployed
            # code deterministically (same seed ⇒ same code)
            if "s_w_vec" in ck:
                from repro_torch.core.grouping import (
                    GroupedHGCCode,
                    GroupTolerance,
                    price_grouped,
                )

                self.code = GroupedHGCCode.build(
                    self.cluster.topo,
                    GroupTolerance(ck["s_e"], tuple(ck["s_w_vec"])),
                    K=ck["K"], seed=self.seed)
                priced = price_grouped(self.cluster.params, self.code.tol,
                                       self.code.loads)
            else:
                self.code = HGCCode.build(
                    self.cluster.topo, Tolerance(ck["s_e"], ck["s_w"]),
                    K=ck["K"], seed=self.seed,
                    construction=getattr(self.planner, "construction",
                                         "random"))
                priced = price_tolerance(self.cluster.params, self.code.tol,
                                         self.code.load)
            # keep the plan (the public λ provider) in step with the code
            self.plan = Plan(code=self.code, tol=self.code.tol,
                             K=self.code.K, expected_iteration_ms=priced,
                             jncss=None)
            if self.verbose:
                print(f"[train] restored replanned code (s_e={ck['s_e']}, "
                      f"s_w={ck['s_w']}, K={ck['K']})")
        saved_streams = extra["streams"]
        # the saved list may exceed code.K (a replan once grew K and later
        # shrank it: streams are never discarded)
        _extend_streams(self.streams, max(self.code.K, len(saved_streams)),
                        self.cfg.vocab, self.part_batch, self.seq_len,
                        self.seed)
        for k, sd in enumerate(saved_streams):
            self.streams[k].load_state_dict(sd)
        if "detector" in extra:
            self.cluster.detector.load_state_dict(extra["detector"])
        self._step = start
        if self.verbose:
            print(f"[train] resumed from step {start}")

    # ------------------------------------------------------------------
    # the train step of the mode
    # ------------------------------------------------------------------
    def _setup_train_step(self):
        """The train step of the mode; in the coded modes the mesh (one
        card, or the ranks of the world), the per-pod EF residuals (one
        list entry per param leaf, in leaf order, this rank's slices
        under TP, the rows of ``mesh.residual_rows()``) and, under FSDP,
        this rank's blocks of the params and the state (they come in
        whole over "data")."""
        from repro_torch.launch import steps as steps_lib

        topo = self.cluster.topo
        # a rebuild after shrink() carries the surviving pods' EF residual
        # rows through; the first build starts empty
        carry = getattr(self, "residual", [])
        self.residual: List[torch.Tensor] = []
        if self.mode == "off":
            self._mesh = None
            self.train_step = steps_lib.make_train_step(
                self.cfg, self.tcfg, optimizer=self._optimizer)
            return
        _require_uniform(topo)
        self._require_dist_uniform_load(self.code)
        from repro_torch.dist import compression
        from repro_torch.dist.mesh import DistMesh, OneCardMesh

        self._validate_pp(self.code)
        if dist.is_initialized() and dist.get_world_size() > 1:
            self._mesh = DistMesh.for_world(topo.n, topo.m[0], self.tp,
                                            pp=self.pp, ranks=self._ranks)
            self._ctx = self._mesh.ctx
            where = ("ranks ("
                     + (f"stage {self.pp} × " if self.pp > 1 else "")
                     + f"pod {self._mesh.pod_ranks} × data "
                     f"{self._mesh.data_ranks} × model {self.tp})")
        else:
            self._mesh = OneCardMesh(topo.n, topo.m[0])
            where = "one-card mesh"
        if self.verbose:
            print(f"[train] dist={self.mode}: {where} (pod={topo.n} "
                  f"× data={topo.m[0]}) on {self.device}, "
                  f"grad_compression={self.tcfg.grad_compression}"
                  + (f", TP degree {self.tp}" if self.tp > 1 else "")
                  + (", seq-parallel activations"
                     if self.seq_shard and self.tp > 1 else "")
                  + (f", pipeline stages {self.pp} × "
                     f"{self.microbatches or self.pp} microbatches"
                     if self.pp > 1 else ""))
        if self.tcfg.grad_compression != "none":
            if carry:
                self.residual = carry
            elif "ef_residual" in self._restored_extra:
                # consume the checkpoint payload (a tree keyed like the
                # params): a later rebuild must carry the LIVE residual,
                # not roll back to this one
                saved = self._restored_extra.pop("ef_residual")
                keys = leaf_keys(self.params)
                mine = self._my_slices(dict(zip(
                    keys, _tree.leaves_like(saved, self.params))),
                    "residual")
                rows = list(self._mesh.residual_rows())
                self.residual = [tensor_from_numpy(
                    np.asarray(mine[k])[rows], self.device).float()
                    for k in keys]
            else:
                self.residual = _tree.leaves(compression.init_pod_residuals(
                    self.params, len(self._mesh.residual_rows())))
        self._slice_data(self._mesh.data_ctx if self.tcfg.fsdp
                         else NULL_CTX)
        self.train_step = steps_lib._make_dist_train_step(
            self.cfg, self.tcfg, self._mesh, optimizer=self._optimizer)

    def _validate_pp(self, code):
        """The pipeline's divisibility up front: the group count by the
        stages and the per-group coded batch rows (load × part batch) by
        the microbatches; again on every replan and shrink (a new code's
        load changes the row count)."""
        if self.pp <= 1:
            return
        loads = getattr(code, "loads", None)
        load = int(loads[0]) if loads else int(code.load)
        validate_pp(self.cfg, self.pp,
                    microbatches=self.microbatches or self.pp,
                    batch_rows=load * self.part_batch)

    def _require_dist_uniform_load(self, code):
        """The coded modes split the batch evenly over (pod, data): every
        worker must carry the same load."""
        if self.mode == "off":
            return
        loads = getattr(code, "loads", None)
        if loads is not None and len(set(loads)) > 1:
            counts: Dict[int, int] = {}
            for d in loads:
                counts[int(d)] = counts.get(int(d), 0) + 1
            majority = max(counts, key=lambda d: (counts[d], -d))
            edge, load = next((i, int(d)) for i, d in enumerate(loads)
                              if int(d) != majority)
            raise ValueError(
                f"dist mode {self.mode!r} splits the coded batch evenly "
                f"over the (pod, data) mesh, which requires every worker "
                f"to carry the same load — but this grouped plan gives "
                f"edge {edge} load D={load} while the majority of edges "
                f"carry D={majority} (per-edge loads: {tuple(loads)}). "
                f"Use a uniform planner, regroup the cluster so loads "
                f"match, or run mode='off'; see docs/planners.md "
                f"(grouped codes under dist modes)")

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def build_batch(self, fast_e, fast_w):
        """The coded global batch for one observed straggler pattern."""
        return build_coded_batch(self.code, self.streams, fast_e, fast_w,
                                 self.seq_len, with_lam=(self._mesh is None))

    def _to_device(self, batch) -> Dict[str, torch.Tensor]:
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(np.asarray(v))
            if k in ("tokens", "targets"):
                t = t.long()
            out[k] = t.to(self.device)
        return out

    def _iteration(self, step: int, force_drop_edge: int = -1,
                   force_drop_step: int = -1, batch=None) -> Dict:
        code, topo = self.code, self.cluster.topo
        fast_e, fast_w, t_iter, wt = sample_straggler_pattern(
            _step_rng(self.seed, step), code, self.cluster.params,
            getattr(code, "load_array", code.load))
        if step == force_drop_step and \
                0 <= force_drop_edge < topo.n and code.tol.s_e > 0:
            # forced straggler drop: only the λ operand changes
            fast_e = tuple(i for i in range(topo.n)
                           if i != force_drop_edge)[: topo.n - code.tol.s_e]
        self.cluster.observe(wt)
        metrics = self._execute(step, fast_e, fast_w, batch)
        metrics["sim_iter_ms"] = t_iter
        metrics["fast_edges"] = fast_e
        return metrics

    def _execute(self, step: int, fast_e, fast_w, batch=None) -> Dict:
        """Run ONE train step under a given completion set — the shared
        tail of :meth:`_iteration` and :meth:`external_step`."""
        code, topo = self.code, self.cluster.topo
        with obs.span("coded.batch"):  # host work the card waits for
            if batch is None:
                batch = self.build_batch(fast_e, fast_w)
            batch = self._to_device(batch)
            if self._mesh is not None:
                from repro_torch.dist import grad_sync

                lam = grad_sync.lam_array_from_code(code, fast_e, fast_w,
                                                    topo.n, topo.m[0])
        if self._mesh is None:
            self.params, self.opt_state, metrics = self.train_step(
                self.params, self.opt_state, batch, step)
        else:
            (self.params, self.opt_state, self.residual,
             metrics) = self.train_step(self.params, self.opt_state, batch,
                                        lam, self.residual, step)
        self.losses.append(float(metrics["loss"]))
        if "aux_loss" in metrics:  # the coded MoE step's Σ aux_ij / n
            self.aux_losses.append(float(metrics["aux_loss"]))
        self._step = step + 1
        return dict(metrics)

    def _check_trains(self) -> None:
        if self.cluster is None:
            raise _serve_only()
        if self._retired:
            raise RuntimeError(
                f"rank {self.rank} was shrunk away: its pod or worker died "
                f"(CodedSession.shrink); it takes part in no later step")

    def external_step(self, fast_e, fast_w, *, worker_totals=None,
                      sim_iter_ms: float = 0.0, batch=None) -> Dict:
        """One train step under an EXTERNALLY observed completion set —
        the orchestrator's entry point (``fast_w`` indexed by edge for
        ALL edges); only the λ operand changes."""
        self._check_trains()
        topo = self.cluster.topo
        need_e = topo.n - self.code.tol.s_e
        if len(set(fast_e)) < need_e:
            raise ValueError(f"completion set has {len(set(fast_e))} "
                             f"edges; the deployed code needs >= {need_e}")
        for i in fast_e:
            need_w = topo.m[i] - self.code.tol.s_w_of(i)
            if len(set(fast_w[i])) < need_w:
                raise ValueError(
                    f"edge {i}: completion set has {len(set(fast_w[i]))} "
                    f"workers; the deployed code needs >= {need_w}")
        if worker_totals is not None:
            self.cluster.observe(worker_totals)
        metrics = self._execute(self._step, tuple(fast_e),
                                [tuple(w) for w in fast_w], batch)
        metrics["sim_iter_ms"] = float(sim_iter_ms)
        metrics["fast_edges"] = tuple(fast_e)
        return metrics

    def step(self, batch=None) -> Dict:
        """One training iteration at the session's current step index
        (a straggler pattern sampled from the cluster model)."""
        self._check_trains()
        return self._iteration(self._step, batch=batch)

    def fit(self, steps: Optional[int] = None, *, replan_every: int = 0,
            force_drop_edge: int = -1, force_drop_step: int = -1,
            stop_after: int = 0) -> Dict:
        """The managed loop: straggler simulation → coded step → detector
        feedback → elastic replan → checkpoint.  ``steps`` is the global
        target step (default ``total_steps``); a resumed session goes on
        from its restored step.  ``stop_after`` simulates a kill: exit
        after N total steps without touching the LR schedule."""
        self._check_trains()
        total = steps if steps is not None else self.tcfg.total_steps
        start = self._step
        t0 = time.time()
        sim_ms = 0.0
        steps_done = 0
        for step in range(start, total):
            steps_done += 1
            m = self._iteration(step, force_drop_edge, force_drop_step)
            sim_ms += m["sim_iter_ms"]
            if self.verbose and (
                    step % self.log_every == 0 or step == total - 1):
                topo = self.cluster.topo
                drop = sorted(set(range(topo.n)) - set(m["fast_edges"]))
                print(f"[train] step {step:5d} loss {self.losses[-1]:.4f} "
                      f"grad_norm {float(m['grad_norm']):.3f} "
                      f"sim_iter {m['sim_iter_ms']:.0f} ms "
                      f"stragglers: edges={drop}")
            if replan_every and (step + 1) % replan_every == 0:
                self.replan()
            # checkpoint AFTER a possible replan, so the saved (tolerance,
            # K) is what the surviving run would train with
            if self.store and (step + 1) % self.checkpoint_every == 0:
                self.save_checkpoint(step + 1)
            if stop_after and step + 1 >= stop_after:
                if self.verbose:
                    print(f"[train] stopping after step {step} (simulated "
                          f"kill)")
                break
        if self.verbose:
            wall = time.time() - t0
            print(f"[train] done: {steps_done} steps in {wall:.1f}s wall, "
                  f"{sim_ms/1e3:.1f}s simulated cluster time, jit cache "
                  f"entries: {self.jit_cache_entries()}")
        return self.report(first_step=start)

    def replan(self, planner: Any = None, cluster: Any = None):
        """Re-run the planner on the detector-updated cluster model; a
        stable plan reuses the deployed code and part streams.  The step
        is eager: a new code only changes the λ and batch operands."""
        if planner is not None:
            self.planner = get_planner(planner)
        if cluster is not None:
            if cluster.topo != self.cluster.topo:
                raise ReplanError(
                    f"replan cluster has topology m={cluster.topo.m}, "
                    f"session is deployed on m={self.cluster.topo.m}",
                    constraint="topology", topo=self.cluster.topo)
            self.cluster = cluster
        plan = self.planner.plan(
            self.cluster.updated_params(self.code.load), self.code.K,
            seed=self.seed, reuse=self.code)
        if plan.code is not self.code:
            self._check_deployable(plan.code)
            if self.verbose:
                print(f"[train] replan: tolerance → (s_e={plan.tol.s_e}, "
                      f"s_w={plan.tol.s_w}), K={plan.K}, "
                      f"T̂={plan.expected_iteration_ms:.0f} ms")
            self.plan = plan
            self.code = plan.code
            _extend_streams(self.streams, self.code.K, self.cfg.vocab,
                            self.part_batch, self.seq_len, self.seed)
        return self.plan

    def _check_deployable(self, code) -> None:
        """A REPLACEMENT code the deployed session cannot run raises a
        structured :class:`ReplanError` (at construction a plain
        ``ValueError``: there is no plan to fall back to)."""
        try:
            self._require_dist_uniform_load(code)
        except ValueError as err:
            raise ReplanError(str(err), constraint="uniform_load",
                              topo=self.cluster.topo) from err
        try:
            self._validate_pp(code)
        except ValueError as err:
            raise ReplanError(str(err), constraint="pp",
                              topo=self.cluster.topo) from err

    def shrink(self, dead_edges=(), dead_workers=()):
        """Drop PERMANENTLY failed nodes, replan on the survivors, and go
        on training.  In the coded modes the mesh is rebuilt with the new
        pod count and the surviving pods keep their own EF residual rows;
        the shrink record rides checkpoints.

        Over ranks every rank of the mesh calls it.  Where pods or
        workers are ranks of their own (``pod_ranks = pods``,
        ``data_ranks = data``) the ranks of a dead pod or worker retire:
        they return the plan, hold no mesh, and raise on any later step;
        the survivors (every stage and model rank of a surviving group)
        rebuild the mesh among themselves, a pod's index renumbered
        among the surviving pods.  A shrink that leaves the edges
        unequal raises the non-uniform topology's ``ValueError`` and
        keeps the session as it was."""
        if self._retired:
            raise RuntimeError(f"rank {self.rank} was shrunk away already")
        old_topo = self.cluster.topo
        old_cluster = self.cluster
        keep = [i for i in range(old_topo.n) if i not in set(dead_edges)]
        self.cluster = self.cluster.shrink(dead_edges, dead_workers)
        try:
            plan = self.planner.plan(self.cluster.params, self.code.K,
                                     seed=self.seed)
            self._check_deployable(plan.code)
        except ReplanError:
            self.cluster = old_cluster
            raise
        except ValueError as err:
            self.cluster = old_cluster
            # the survivors cannot host ANY compatible plan: keep the
            # pre-shrink session intact and report what broke
            raise ReplanError(
                str(err), constraint="plan",
                topo=old_cluster.shrink(dead_edges, dead_workers).topo,
            ) from err
        topo = self.cluster.topo
        if getattr(self._mesh, "ranks", None) is not None and \
                len(set(topo.m)) != 1:
            self.cluster = old_cluster  # before any rank retires
            _require_uniform(topo)
        self.plan = plan
        self.code = plan.code
        _extend_streams(self.streams, self.code.K, self.cfg.vocab,
                        self.part_batch, self.seq_len, self.seed)
        if self._mesh is None:
            self._log_shrink()
            return self.plan
        if getattr(self._mesh, "ranks", None) is not None:
            from repro_torch.dist import mesh as mesh_lib

            alive = mesh_lib.survivors(self._mesh, dead_edges, dead_workers)
            mesh_lib.subset_group(alive)  # every rank of the world
            # FSDP: whole over the old data group while its dead ranks
            # still hold their blocks; the setup cuts them for the new one
            self._unslice_data()
            if self.rank not in alive:
                self._retire()
                return self.plan
            self._ranks = alive
            self.verbose = self._verbose and self.rank == alive[0]
        self._log_shrink()
        if self.residual and len(self._mesh.residual_rows()) > 1:
            # surviving pods keep their own rows (a pod rank holds only
            # its own)
            idx = torch.as_tensor(keep, device=self.device)
            self.residual = [r.index_select(0, idx) for r in self.residual]
        self._setup_train_step()
        return self.plan

    def _log_shrink(self) -> None:
        if self.verbose:
            print(f"[train] shrink: topology → m={self.cluster.topo.m}, "
                  f"(s_e={self.code.tol.s_e}, s_w={self.code.tol.s_w}), "
                  f"K={self.code.K}")

    def _retire(self) -> None:
        """This rank's pod or worker died: no mesh, no state, no later
        collective."""
        self._retired = True
        self._mesh = None
        self.verbose = False
        self.train_step = None
        self.params = self.opt_state = None
        self.residual = []
        self._data, self._data_axes = NULL_CTX, {}

    # ------------------------------------------------------------------
    # checkpointing / reporting
    # ------------------------------------------------------------------
    def save_checkpoint(self, step: Optional[int] = None) -> str:
        """Save params, optimizer state and the elastic state (streams,
        detector, deployed code, shrink record, EF residuals keyed like
        the params) in the reference's layout."""
        if self.store is None:
            raise RuntimeError("session has no checkpoint_dir")
        self._check_trains()
        step = self._step if step is None else step
        if dist.is_initialized() and dist.get_world_size() > 1:
            return self._save_gathered(step)
        extra = self._extra_state()
        if self.tcfg.grad_compression != "none" and self._mesh is not None:
            extra["ef_residual"] = _tree.unflatten_like(self.params,
                                                        self.residual)
        return self.store.save(
            step, {"params": self.params, "opt_state": self.opt_state},
            extra=extra)

    def _extra_state(self) -> Dict:
        # the detector rides the top-level key only (one source of truth)
        cluster_state = self.cluster.state_dict()
        cluster_state.pop("detector", None)
        return {
            "streams": [s.state_dict() for s in self.streams],
            "detector": self.cluster.detector.state_dict(),
            "code": _code_desc(self.code),
            "cluster": cluster_state,
        }

    def _gather(self, flat, kind: str = "params") -> Dict[str, np.ndarray]:
        """The full arrays of every rank's flat-key slices, over "model",
        "stage" and the FSDP "data" (collective)."""
        axes, st, data = self._split_axes(flat, kind)
        return gather_params(flat, self.cfg, self._ctx, axes,
                             getattr(self._mesh, "stage_ctx", None), st,
                             self._data, data)

    def _save_gathered(self, step: int) -> str:
        """The checkpoint of a session over ranks: every rank gathers the
        full arrays (params, optimizer state, every pod's EF residual
        row, one leaf at a time), the mesh's first rank writes them in the
        pp-1/tp-1 format, and every rank returns once the file is in
        place."""
        params = self._gather(_flatten(self.params))
        opt = self._gather(_flatten(self.opt_state), "state")
        extra = self._extra_state()
        if self.tcfg.grad_compression != "none":
            keys = leaf_keys(self.params)
            rows = {k: self._mesh.gather_pod_rows(r)
                    for k, r in zip(keys, self.residual)}
            extra["ef_residual"] = self._gather(rows, "residual")
        path = ""
        ranks = self._mesh.ranks if self._mesh is not None else (0,)
        if self.rank == ranks[0]:
            path = self.store.save(step, {"params": params,
                                          "opt_state": opt}, extra=extra)
        dist.barrier(group=getattr(self._mesh, "group", None))
        return path

    def full_params(self) -> Dict[str, np.ndarray]:
        """The params as full host arrays by flat key (under TP, PP and
        FSDP gathered from every rank: collective)."""
        return self._gather(_flatten(self.params))

    def _whole_params(self):
        """The params the forward needs: this rank's, whole over "data"
        under FSDP (gathered: collective), or under PP the whole layer
        stacks (gathered over "stage" too) at this rank's "model"
        slices."""
        if self.pp == 1:
            return self._whole_over_data(self.params)
        return params_from_numpy(
            shard_params(self.full_params(), self.cfg, self.tp,
                         self.model_rank, self._axes), self.device)

    def jit_cache_entries(self) -> int:
        """-1: the port's step is eager, so there is no executable cache
        to count (the reference's own "cannot tell" value)."""
        return -1

    def report(self, first_step: int = 0) -> Dict:
        """The metrics payload the train CLI writes to --metrics-out."""
        return {
            "dist": self.mode,
            "first_step": first_step,
            "losses": self.losses,
            "jit_cache_entries": self.jit_cache_entries(),
        }

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------
    def eval_step(self, batch) -> Dict[str, float]:
        """Loss/metrics of one batch under the current params (no update,
        no coding — plain evaluation)."""
        batch = self._to_device(batch)
        params = self._whole_params()
        with torch.no_grad():
            _, metrics = tf.loss_and_metrics(params, self.cfg, batch,
                                             ctx=self._ctx)
        return {k: float(v) for k, v in metrics.items()}

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------
    def _serve_fns(self, max_len: int, exact: bool):
        """The (prefill, decode) pair of ``repro_torch.api.serving``,
        built once per ``(max_len, exact)``."""
        key = (max_len, exact)
        if key not in self._serve_cache:
            self._serve_cache[key] = (
                serving.make_prefill_fn(self.cfg, max_len, exact=exact,
                                        ctx=self._ctx),
                serving.make_decode_fn(self.cfg, ctx=self._ctx))
        return self._serve_cache[key]

    @torch.inference_mode()
    def generate(self, prompts, gen_len: int, max_len: Optional[int] = None,
                 *, enc_frames=None, greedy: bool = True, seed: int = 0,
                 exact_handoff: bool = False) -> np.ndarray:
        """Batched generation from the session's params: bulk prefill →
        decode loop → (B, gen_len) int32 tokens (numpy); an encoder–
        decoder model takes its ``enc_frames`` (B, T_enc, d) and hands
        off token by token.  The float32 master params serve in the
        model's compute dtype (``cfg.dtype``), the one dtype the decode
        kernel reads q and the cache in."""
        prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.int64,
                                  device=self.device)
        max_len = max_len or int(prompts.shape[1]) + gen_len + 1
        prefill_fn, decode_fn = self._serve_fns(max_len, exact_handoff)
        params = tf.cast_params(self._whole_params(), self.cfg)
        return serving.generate_tokens(
            params, self.cfg, prompts, gen_len, prefill_fn=prefill_fn,
            decode_fn=decode_fn,
            enc_frames=serving.frames_on(enc_frames, self.device),
            greedy=greedy, seed=seed, ctx=self._ctx)
