"""Training loops of the walk embedders (skip-gram style models).

Port of ``graphneuralnetwork_tpu/train/embed_loop.py``: one masked-BCE
trainer for DeepWalk, Node2vec, Struc2Vec and MetaPath2Vec
(``make_skipgram_step``) and LINE's combined first- and second-order loss
(``make_line_step``), with Adam at optax's defaults.

``train_skipgram`` runs one of two loops, as JAX's does:

  * the host loop (the CPU's, as JAX's CPU backend runs it): each epoch
    shuffles the corpus with the caller's numpy ``rng`` (``minibatches``)
    and steps batch by batch;
  * the device loop (the card's default): the corpus goes to the device
    once and ``CapturedEpochs`` trains it; each epoch draws its
    permutation from a ``torch.Generator`` on the device and keeps the
    first ``nb * batch_size`` rows, every step writes its loss and
    accuracy into a device buffer, and the host reads the buffer once an
    epoch. On the card the step is captured once as a CUDA graph that
    reads batch ``index`` (a device counter) and replayed ``nb`` times;
    this is the counterpart of JAX's one ``lax.scan`` dispatch an epoch.

JAX's device loop shuffles from threefry keys, the port's from a torch
generator, so card runs cannot be matched to JAX's draw for draw; the
CPU's host loop can, from the same parameters and ``rng``.

Data parallelism (JAX's ``shard_batch_arrays``, which GSPMD turns into a
gradient psum): ``shard_batch_arrays`` gives each rank of a mesh its
contiguous block of batch rows, and ``make_skipgram_step(..., mesh=mesh)``
steps on each rank's share of the global loss with the gradients summed
over the ranks (``parallel/dp.py``), so a step equals the single-device
step on the whole batch.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..core.device import resolve_device
from ..sampling.skipgram import minibatches
from .metrics import binary_accuracy, masked_sigmoid_bce
from .scan_loop import EpochGraph


def _init_params(model: nn.Module, seed: int) -> None:
    """The model's initial parameters, from a CPU generator seeded with
    ``seed`` (the tests replace this with JAX's initial parameters)."""
    model.reset_parameters(torch.Generator().manual_seed(seed))


def make_adam(params, lr: float, device: torch.device,
              weight_decay: Optional[float] = None) -> torch.optim.Optimizer:
    """Adam (or AdamW with ``weight_decay``) at optax's defaults (betas
    0.9 / 0.999, eps 1e-8); dense, so every row of a table decays its
    moments at every step, as optax's does. Capturable on CUDA."""
    kw = dict(lr=lr, betas=(0.9, 0.999), eps=1e-8,
              capturable=device.type == "cuda")
    if weight_decay is None:
        return torch.optim.Adam(params, **kw)
    return torch.optim.AdamW(params, weight_decay=weight_decay, **kw)


def skipgram_loss(model, centers, ctx_neg, labels, mask):
    """(masked BCE of the logits, their binary accuracy), device scalars."""
    logits = model(centers, ctx_neg)
    return (masked_sigmoid_bce(logits, labels, mask),
            binary_accuracy(logits.detach(), labels, mask))


def line_loss(model, centers, ctx_neg, labels, mask, weights):
    """(BCE of the first-order logits + BCE of the second-order logits
    scaled by each center's weight, 0): LINE's loss, no accuracy."""
    first, second = model(centers, ctx_neg)
    loss = (masked_sigmoid_bce(first, labels, mask)
            + masked_sigmoid_bce(second * weights[:, None], labels, mask))
    return loss, torch.zeros((), device=loss.device)


def _update(optimizer: torch.optim.Optimizer, loss: torch.Tensor) -> None:
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()


def shard_batch_arrays(arrays, mesh) -> tuple:
    """This rank's contiguous block of rows of each batch array (numpy or
    tensor, the rows split as evenly as they go, the first ranks taking
    one more), on the mesh's device; the counterpart of JAX's row-sharded
    placement over the mesh."""
    return tuple(torch.tensor_split(torch.as_tensor(a), mesh.size)[mesh.rank]
                 .contiguous().to(mesh.device) for a in arrays)


def make_skipgram_step(model, optimizer, mesh=None):
    """``step(centers, ctx_neg, labels, mask) -> (loss, acc)``: one
    optimizer step on the masked BCE. With ``mesh`` the arrays are this
    rank's rows (``shard_batch_arrays``) and the step is data-parallel:
    each rank's loss is its rows' share of the batch mean (``Σ_local /
    global rows``), the gradients are summed over the ranks, and the loss
    and accuracy returned are the whole batch's."""
    if mesh is None:
        def step(centers, ctx_neg, labels, mask):
            loss, acc = skipgram_loss(model, centers, ctx_neg, labels, mask)
            _update(optimizer, loss)
            return loss.detach(), acc

        return step

    from ..parallel.collectives import all_reduce_sum
    from ..parallel.dp import dp_step, global_count

    def dp(centers, ctx_neg, labels, mask):
        rows = centers.shape[0]
        share = rows / global_count(rows, mesh)
        acc = []

        def local_loss():
            loss, a = skipgram_loss(model, centers, ctx_neg, labels, mask)
            acc.append(a)
            return loss * share

        loss = dp_step(model.parameters(), optimizer, local_loss, mesh)
        # the batch's accuracy: each rank's weighted by its valid entries
        valid = mask.float().sum()
        hits = all_reduce_sum(torch.stack([acc[0] * valid, valid]), mesh)
        return loss, hits[0] / torch.clamp_min(hits[1], 1.0)

    return dp


def make_line_step(model, optimizer):
    """``step(centers, ctx_neg, labels, mask, weights) -> (loss,)``: one
    optimizer step on ``line_loss``."""
    def step(centers, ctx_neg, labels, mask, weights):
        loss, _ = line_loss(model, centers, ctx_neg, labels, mask, weights)
        _update(optimizer, loss)
        return (loss.detach(),)

    return step


class CapturedEpochs:
    """Epochs of ``nb = n_rows // batch_size`` optimizer steps over the
    rows of a corpus on the device. ``step(sel)`` trains on the rows
    ``sel`` ([batch_size] int64) and returns float32 ``[n_out]`` (its loss
    and accuracy); ``run()`` draws the epoch's permutation from
    ``generator`` (without one, the rows in order: the caller has shuffled
    them, as ``HostDrawnEpochs`` does), runs every step and returns the
    float32 ``[nb, n_out]`` rows, read once.

    On CUDA ``run()`` replays a CUDA graph (``scan_loop.EpochGraph``) of
    one step that reads its batch at ``index``, a device counter the graph
    advances, ``nb`` times. The first ``run()`` runs its first step
    eagerly on a side stream (the warm-up that creates the optimizer's
    state) and captures the second; every later epoch only replays.
    ``run_eager()`` runs the same epoch step by step from the host (the
    CPU's path, and the card's reference for the captured one)."""

    def __init__(self, step: Callable[[torch.Tensor], torch.Tensor],
                 n_rows: int, batch_size: int, n_out: int,
                 optimizer: torch.optim.Optimizer,
                 generator: Optional[torch.Generator],
                 device: torch.device):
        self.step, self.optimizer, self.generator = step, optimizer, generator
        self.device = device
        self.n_rows, self.batch_size = n_rows, batch_size
        self.nb = n_rows // batch_size
        if self.nb < 1:
            raise ValueError(f"{n_rows} rows make no batch of {batch_size}")
        self.perm = torch.arange(self.nb * batch_size,
                                 device=device).view(self.nb, batch_size)
        self.index = torch.zeros(1, dtype=torch.int64, device=device)
        self.rows = torch.zeros(self.nb, n_out, device=device)
        self.graph: Optional[EpochGraph] = None
        self.captured = False

    def steps(self, k: int) -> None:
        """``k`` steps from batch ``index`` of the current permutation."""
        for _ in range(k):
            sel = self.perm.index_select(0, self.index)[0]
            self.rows.index_copy_(0, self.index, self.step(sel)[None])
            self.index += 1

    def _shuffle(self) -> None:
        if self.generator is not None:
            perm = torch.randperm(self.n_rows, generator=self.generator,
                                  device=self.device)
            self.perm.copy_(perm[:self.nb * self.batch_size].view(
                self.nb, self.batch_size))
        self.index.zero_()

    def _read(self) -> np.ndarray:
        # the epoch's one host read; a copy, as the next epoch rewrites
        # the buffer
        return self.rows.cpu().numpy().copy()

    def run_eager(self) -> np.ndarray:
        self._shuffle()
        self.steps(self.nb)
        return self._read()

    def run(self) -> np.ndarray:
        if self.device.type != "cuda":
            return self.run_eager()
        self._shuffle()
        replays = self.nb
        if self.graph is None:
            self.graph = EpochGraph(self.device)
            self.graph.warm_up(lambda: self.steps(1))
            replays -= 1
        if replays and not self.captured:
            # the captured backward allocates the step's gradients anew
            self.optimizer.zero_grad(set_to_none=True)
            self.graph.capture(lambda: self.steps(1))
            self.captured = True
        for _ in range(replays):
            self.graph.replay()
        return self._read()


class HostDrawnEpochs:
    """Epochs whose batches the host draws, as JAX's device loops do for
    GATNE: each epoch's arrays (rows already in the epoch's order, ``nb *
    batch_size`` of them) go to the device in one copy into fixed buffers,
    and ``CapturedEpochs`` (``loop``, no generator) steps through them in
    order, ``step(*batch) -> loss`` on ``batch_size`` rows of every
    buffer. ``run(arrays)`` / ``run_eager(arrays)`` return the epoch's
    float32 losses [nb]."""

    def __init__(self, step: Callable[..., torch.Tensor],
                 arrays: Sequence[np.ndarray], batch_size: int,
                 optimizer: torch.optim.Optimizer, device: torch.device):
        self.buffers = [torch.empty_like(_host_tensor(a), device=device)
                        for a in arrays]
        self.loop = CapturedEpochs(
            lambda sel: step(*(b[sel] for b in self.buffers))[None],
            len(arrays[0]), batch_size, 1, optimizer, None, device)

    def _load(self, arrays: Sequence[np.ndarray]) -> None:
        for buf, a in zip(self.buffers, arrays):
            buf.copy_(_host_tensor(a))

    def run(self, arrays: Sequence[np.ndarray]) -> np.ndarray:
        self._load(arrays)
        return self.loop.run()[:, 0]

    def run_eager(self, arrays: Sequence[np.ndarray]) -> np.ndarray:
        self._load(arrays)
        return self.loop.run_eager()[:, 0]


def batch_step(model, optimizer, loss_fn: Callable,
               arrays: Sequence[torch.Tensor]):
    """``step(sel) -> [loss, acc]`` for ``CapturedEpochs``: one optimizer
    step of ``loss_fn(model, *batch)`` on the rows ``sel`` of every array
    (device tensors)."""
    def step(sel):
        loss, acc = loss_fn(model, *(a[sel] for a in arrays))
        _update(optimizer, loss)
        return torch.stack([loss.detach(), acc.detach()])

    return step


def spread_padding(ctx_neg: torch.Tensor, mask: torch.Tensor,
                   vocab: int) -> torch.Tensor:
    """``ctx_neg`` with each padded slot (mask 0; ``batchify`` gives it id
    0) naming id ``slot % vocab`` instead. A padded slot's logit is
    masked out of the loss and the accuracy and its gradient is exactly
    zero, so losses and gradients are unchanged; but the tables' gradient
    (``index_put_``'s sorted accumulation, one warp a run of equal ids)
    no longer sums every padded slot of a batch in one run: 84 % of
    DeepWalk's context slots, 5.9 ms of a 6.2 ms step on an H100
    (``tools/embed_step.py``)."""
    spread = torch.arange(ctx_neg.numel(), device=ctx_neg.device)
    return torch.where(mask > 0, ctx_neg, spread.view_as(ctx_neg) % vocab)


def _device_corpus(arrays: Sequence[np.ndarray], vocab: int,
                   device: torch.device) -> list[torch.Tensor]:
    """(centers, ctx_neg, labels, mask, ...) on ``device``, the padded
    slots of ``ctx_neg`` spread over the vocabulary
    (``spread_padding``)."""
    out = [_to_device(a, device) for a in arrays]
    out[1] = spread_padding(out[1], out[3], vocab)
    return out


def skipgram_epochs(model, optimizer, loss_fn: Callable,
                    arrays: Sequence[np.ndarray], batch_size: int, seed: int,
                    device: torch.device) -> CapturedEpochs:
    """The device loop of ``train_skipgram``: ``arrays`` moved to
    ``device`` once (``_device_corpus``), each step ``loss_fn`` on a batch
    of their rows, the permutation drawn from a generator seeded with
    ``seed ^ 0x5F5E``."""
    generator = torch.Generator(device=device).manual_seed(seed ^ 0x5F5E)
    vocab = model.embedding().shape[0]
    return CapturedEpochs(
        batch_step(model, optimizer, loss_fn,
                   _device_corpus(arrays, vocab, device)),
        len(arrays[0]), batch_size, 2, optimizer, generator, device)


def _host_tensor(a: np.ndarray) -> torch.Tensor:
    """A corpus array as a CPU tensor: ids as int64, the rest float32."""
    a = np.asarray(a)
    dtype = np.int64 if np.issubdtype(a.dtype, np.integer) else np.float32
    return torch.from_numpy(np.ascontiguousarray(a, dtype))


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A corpus array on ``device``: ids as int64, the rest float32."""
    return _host_tensor(a).to(device)


def _log(verbose: bool, epoch: int, loss: float, acc: float,
         t0: float) -> None:
    if verbose:
        print(f"epoch {epoch}: loss {loss:.4f} acc {acc:.4f} "
              f"({time.perf_counter() - t0:.1f}s)")


def train_skipgram(
    model: nn.Module, arrays, *,
    epochs: int, batch_size: int, lr: float,
    rng: Optional[np.random.Generator] = None,
    seed: int = 0, verbose: bool = False,
    step_fn_factory: Callable = make_skipgram_step,
    extra_batch_arrays: tuple = (),
    device_loop: Optional[bool] = None,
    device_loss_fn: Optional[Callable] = None,
    device: str | torch.device = "cuda",
):
    """Minibatch training of ``model`` (initialised from ``seed``, moved
    to ``device``) on ``arrays`` = (centers, ctx_neg, labels, mask) plus
    ``extra_batch_arrays``, with Adam at ``lr``. Returns (the parameters
    by name, on ``device``; history [(epoch, mean loss, mean accuracy)]).

    ``device_loop`` defaults to the device loop on CUDA when its loss is
    known: the plain skip-gram step, or ``device_loss_fn(model, *batch)
    -> (loss, acc)`` (LINE's ``line_loss``). Asking for the device loop
    with a custom ``step_fn_factory`` and no ``device_loss_fn`` raises:
    the captured step cannot express the custom step, and the skip-gram
    loss in its place would train the wrong objective. A corpus smaller
    than one batch takes the host loop, as in JAX."""
    device = resolve_device(device)
    rng = rng or np.random.default_rng(seed)
    _init_params(model, seed)
    model.to(device)
    optimizer = make_adam(model.parameters(), lr, device)
    all_arrays = tuple(arrays) + tuple(extra_batch_arrays)
    plain = step_fn_factory is make_skipgram_step
    if device_loop is None:
        device_loop = ((plain or device_loss_fn is not None)
                       and device.type == "cuda")
    elif device_loop and not plain and device_loss_fn is None:
        raise ValueError(
            "device_loop=True with a custom step_fn_factory requires a "
            "device_loss_fn: the captured step cannot express the custom "
            "step, and the default skip-gram loss would train the wrong "
            "objective (use device_loop=False, or supply device_loss_fn)")
    if len(all_arrays[0]) < batch_size:
        device_loop = False

    history = []
    t0 = time.perf_counter()
    if device_loop:
        loop = skipgram_epochs(model, optimizer,
                               device_loss_fn or skipgram_loss, all_arrays,
                               batch_size, seed, device)
        for epoch in range(1, epochs + 1):
            rows = loop.run().astype(np.float64)
            history.append((epoch, float(rows[:, 0].mean()),
                            float(rows[:, 1].mean())))
            _log(verbose, epoch, *history[-1][1:], t0)
        return _params(model), history

    step = step_fn_factory(model, optimizer)
    vocab = model.embedding().shape[0]
    for epoch in range(1, epochs + 1):
        outs = [step(*_device_corpus(batch, vocab, device))
                for batch in minibatches(all_arrays, batch_size, rng)]
        nb = max(len(outs), 1)
        if outs:        # the epoch's one host read
            sums = torch.stack([torch.stack(
                [o[0], o[1] if len(o) > 1 else torch.zeros_like(o[0])])
                for o in outs]).double().sum(0).tolist()
        else:
            sums = [0.0, 0.0]
        history.append((epoch, sums[0] / nb, sums[1] / nb))
        _log(verbose, epoch, *history[-1][1:], t0)
    return _params(model), history


def _params(model: nn.Module) -> dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def get_embedding(params, table: str = "center") -> np.ndarray:
    """The learned node embedding table ``table`` as a numpy array."""
    return params[table].detach().cpu().numpy()
