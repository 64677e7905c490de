"""Training, evaluation and serving runtime.

Counterpart of ``textgcn_tpu/train/trainer.py`` on one device:

* ``fit``: the epoch loop.  Each epoch samples its BPR triples on the
  device, then each batch runs one full-graph propagation with hash edge
  dropout (fresh salts per step from the trainer's generator), the BPR +
  L2 loss, its backward and an Adam step.  The loss components are summed
  on the device and fetched once per epoch, where the NaN guard runs; at
  every ``evaluate_every``-th epoch they are logged as the JAX package
  logs them, the model is evaluated and checkpointed, and the early stop
  is checked;
* ``checkpoint``: ``latest_checkpoint.pkl`` in the JAX package's format,
  copied to ``best.pkl`` when recall@smallest-k reaches a new maximum on
  the params it was measured on; beside it ``resume_state.pkl`` (unless
  ``--no_resume_state``): the epoch, the metrics history, the
  ``RESUME_CONFIG_FIELDS``, the Adam state and the states of the two
  generators (and of the model's own, ``adv_sampling``'s candidates);
  with ``--ckpt_backend orbax`` the same trees as ``.orbax`` directories
  of ``torch.distributed.checkpoint`` (``train/checkpoint.py``);
* ``resume``: restores all of that; ``fit`` then goes on at the next
  epoch, bit for bit the run that was not stopped;
* a SIGTERM during ``fit`` lets the epoch finish, checkpoints it and
  returns (``textgcn_tpu/train/trainer.py:364-443``);
* a model that propagates twice a step (``adv_sampling``'s rank and
  loss passes) takes two salt pairs a step (``salt_pairs_per_step``);
  every other model's salt stream is the one-pair stream;
* ``--refresh_every N``: the propagated rest is recomputed without
  gradients at steps 0, N, 2N, ... of each epoch, and every step's loss
  runs on the fresh ego tables plus that rest (``models/lightgcn.py``);
* ``--freeze``: Adam takes the trainable parameters only (the LTR heads'
  tables take ``requires_grad=False`` and stay bit-unchanged), the
  trajectory of optax's ``set_to_zero`` for the frozen leaves;
* ``load``: a file or a run dir (``best.pkl``), re-evaluated at once,
  then the metrics history is reset; before ``fit`` it warm-starts the
  parameters the checkpoint has (``load_params``: a plain ``lgcn``
  checkpoint fills an LTR model's tables, its tower keeps its init);
* ``evaluate``: masked full-catalogue top-k over the test users and the
  five metrics per k (a model's ``on_evaluate`` logs first);
* ``predict``: ranked items (+ scores rounded to 4 decimals) for any user
  list, optionally written to ``predictions.tsv`` with external ids, in
  the bytes pandas writes for the JAX package;
* ``export_reprs``: the propagated tables as ``.npy``, and the collapsed
  factors of a model whose scores are one product (its
  ``supports_fused_sharded_topk``, as the JAX package gates them: not a
  tree head).

Each ``evaluate``/``predict``/``export_reprs`` call propagates once, as
the JAX package's eval function does.

On a mesh (``model.mesh``) every rank runs the same loop: the same epochs
and salts from the same seeds, its part of each batch (``model.loss``),
the gradients of the replicated parameters (conv layers, an LTR tower:
every one but the row-sharded tables) summed over the ranks in one
flattened all-reduce, Adam on its rows and on the whole replicated
parameters (elementwise, so it is the global Adam), the loss sums
all-reduced once an epoch, the catalogue-sharded top-k.  Every rank
computes the metrics; logs, ``predictions.tsv``, exports and pickle
checkpoints come from rank 0 only, after the collectives that gather the
tables (``trainer.py:244, 407, 499, 527, 577`` in the JAX package), while
the cooperative ``--ckpt_backend orbax`` has every rank write its own
rows; a resume
restores every rank's own rows of the tables and of their Adam state, and
the replicated parameters' Adam state and the generators as rank 0 held
them (every rank's are the same: ``adv_sampling``'s model generator draws
the whole batch's candidates on every rank).

``--steps_per_call`` is accepted and ignored.
"""

from __future__ import annotations

import csv
import logging
import os
import signal
import time

import numpy as np
import torch

from ..config import Config
from ..data.core import InteractionData
from ..ops import metrics as metrics_mod
from ..parallel.multihost import is_primary
from ..parallel.sharded import all_reduce_sum
from ..utils.profiling import StepTimer, span
from ..weights import RowShard, params_from_jax, params_to_jax
from .checkpoint import make_checkpointer

log = logging.getLogger('textgcn_tpu_torch')

# config fields that change the training trajectory: stamped into the
# resume payload and checked by ``resume`` (the JAX package's list)
RESUME_CONFIG_FIELDS = (
    'model', 'emb_size', 'batch_size', 'neg_samples', 'lr', 'reg_lambda',
    'dropout', 'n_layers', 'single', 'refresh_every', 'seed',
    'evaluate_every')


class Trainer:

    def __init__(self, cfg: Config, model, data: InteractionData):
        """``model``'s device is the trainer's.  Its generators are seeded
        from ``cfg.seed``: one on the device draws the epochs' samples,
        one on the host draws the per-step dropout salts (so no step waits
        for the device to hand them back)."""
        self.cfg = cfg
        self.model = model
        self.data = data
        self.k = tuple(sorted(cfg.k))
        if data.n_items <= max(self.k):
            raise ValueError(f'all k must be less than number of items '
                             f'({data.n_items}), got k={list(self.k)}')
        self.metrics_names = list(metrics_mod.METRICS)
        self.metrics_logger = {m: np.zeros((0, len(self.k)))
                               for m in self.metrics_names}
        self.last_metrics: dict[str, list[float]] | None = None
        self.loss_history: list[dict[str, float]] = []
        self.optimizer = torch.optim.Adam(
            [p for p in model.parameters() if p.requires_grad], lr=cfg.lr)
        self.generator = torch.Generator(device=model.device).manual_seed(
            cfg.seed)
        self.salt_generator = torch.Generator().manual_seed(cfg.seed + 1)
        self._checkpointer = make_checkpointer(cfg.ckpt_backend)
        self.primary = is_primary()
        # the epoch whose metrics row describes the params as they are
        # now: best.pkl is promoted only from a checkpoint at that epoch
        self._last_eval_epoch: int | None = None
        self._start_epoch = 1           # advanced by resume()
        self._stop_requested = False    # set by the SIGTERM handler
        self._requests = 0              # _predict_users calls, for spans
        # on a mesh, the stepped parameters every rank holds whole
        self._replicated = [p for n, p in self._adam_entries()
                            if model.mesh is not None
                            and self._whole_rows(n) is None]

    # ------------------------------------------------------------------
    # training

    def train_step(self, batch, w_pairs):
        """One Adam step on ``batch`` with the dropout salts ``w_pairs``;
        returns the loss and its components, detached, on the device."""
        self.optimizer.zero_grad(set_to_none=True)
        with span('train.forward'):
            loss, aux = self.model.loss(batch, w_pairs=w_pairs)
        with span('train.backward'):
            loss.backward()
            if self._replicated:
                self._sum_replicated_grads()
        with span('train.adam'):
            self.optimizer.step()
        return loss.detach(), {c: v.detach() for c, v in aux.items()}

    def _sum_replicated_grads(self):
        """On a mesh, the replicated parameters' gradients summed over the
        ranks, in one all-reduce of their concatenation: each rank's loss
        is its share of the batch, so the sum is the single-card gradient.
        """
        params = self._replicated
        flat = torch.cat([p.grad.reshape(-1) for p in params])
        all_reduce_sum(flat)
        for p, g in zip(params, flat.split([p.numel() for p in params])):
            p.grad = g.view_as(p)

    def step_salts(self):
        """One step's dropout salts from the salt generator: a model's
        ``salt_pairs_per_step`` draws of the (to_user, to_item) pairs, as
        a tuple of them when it takes more than one."""
        model = self.model
        with span('train.salts'):
            draws = tuple(model.graph_op.weights(self.salt_generator,
                                                 model.dropout)
                          for _ in range(model.salt_pairs_per_step))
        return draws[0] if len(draws) == 1 else draws

    def epoch_step(self, step: int, batch):
        """Step ``step`` of an epoch: its salts (``step_salts``), under
        ``--refresh_every N`` the rest recomputed with the first pair of
        them when ``step % N == 0`` (the model keeps it until the epoch
        ends), then ``train_step``; all in the span ``train.step``."""
        model = self.model
        with span('train.step', (step,)):
            w_pairs = self.step_salts()
            refresh = self.cfg.refresh_every
            if refresh and step % refresh == 0:
                first = w_pairs if model.salt_pairs_per_step == 1 \
                    else w_pairs[0]
                with span('train.refresh'), torch.no_grad():
                    model.cached_rest = model.propagate_rest(w_pairs=first)
            return self.train_step(batch, w_pairs)

    def train_epoch(self) -> dict[str, torch.Tensor]:
        """Sample an epoch, step through its batches; the sums of the loss
        and its components stay on the device."""
        model = self.model
        batches = model.sample_batches(self.generator, self.cfg.batch_size)
        losses = []
        comps = {c: [] for c in self.model.loss_components}
        try:
            for step, batch in enumerate(batches):
                loss, aux = self.epoch_step(step, batch)
                losses.append(loss)
                for c in comps:
                    comps[c].append(aux[c])
        finally:
            model.cached_rest = None
        sums = {c: torch.stack(v).sum() for c, v in comps.items()}
        sums['loss'] = torch.stack(losses).sum()
        if model.mesh is not None:
            # each rank's losses are its share of each batch's
            summed = all_reduce_sum(torch.stack(list(sums.values())))
            sums = dict(zip(sums, summed))
        return sums

    def _finish_epoch(self, epoch: int, sums) -> dict[str, float]:
        """Fetch one epoch's sums and guard against a NaN loss (the JAX
        package checks once per epoch too)."""
        sums = {c: float(v) for c, v in sums.items()}
        if np.isnan(sums['loss']):
            raise FloatingPointError(f'loss is NA at epoch {epoch}')
        log.debug('Epoch %d: %s', epoch, self._format_components(sums))
        return sums

    def _format_components(self, sums) -> str:
        return ' '.join(f'{c} = {sums[c]:.4f}'
                        for c in self.model.loss_components)

    def _check_refresh(self):
        """The JAX package's refusals of ``--refresh_every``."""
        if not self.cfg.refresh_every:
            return
        if not getattr(self.model, 'supports_cached_propagation', False):
            raise ValueError(f'--refresh_every is not supported by model '
                             f'{self.cfg.model!r} (no cached-propagation '
                             'path)')
        if self.model.single:
            raise ValueError('--refresh_every requires the layer-mean '
                             'combination (incompatible with --single)')

    def _install_preemption_handler(self):
        """SIGTERM -> finish the epoch, checkpoint it and return from
        ``fit``; the handler only sets a flag.  Returns the undo (a no-op
        outside the main thread, where no handler can be set)."""
        def handler(signum, frame):
            self._stop_requested = True
            log.warning('Received %s: checkpointing and stopping at the '
                        'end of this epoch (resume with --resume)',
                        signal.Signals(signum).name)

        try:
            prev = signal.signal(signal.SIGTERM, handler)
        except ValueError:      # not the main thread
            return lambda: None
        return lambda: signal.signal(signal.SIGTERM, prev)

    def _stop(self) -> bool:
        """Whether a SIGTERM asked to stop; on a mesh, whether any rank's
        did, so that every rank stops after the same epoch."""
        stop = self._stop_requested
        if self.model.mesh is not None:
            flag = torch.tensor([float(stop)], device=self.model.device)
            stop = bool(all_reduce_sum(flag) > 0)
        return stop

    def fit(self) -> list[dict[str, float]]:
        """Train from the epoch after the last one done (1, or the resumed
        epoch + 1) to ``cfg.epochs`` with eval, checkpoint and early stop
        every ``evaluate_every`` epochs; returns each epoch's loss sums
        (also kept in ``loss_history``)."""
        self._check_refresh()
        self._stop_requested = False
        restore_handler = self._install_preemption_handler()
        try:
            stopped = self._fit_loop()
        finally:
            restore_handler()
        cfg = self.cfg
        if not stopped and cfg.epochs % cfg.evaluate_every:
            # the last epoch was no eval epoch: save latest only
            self.checkpoint(cfg.epochs)
        return self.loss_history

    def _fit_loop(self) -> bool:
        """The epochs of ``fit``; True when an early stop or a SIGTERM
        ended them (both checkpointed already)."""
        cfg = self.cfg
        history = self.loss_history = []
        # one tick an epoch over the epochs since the last evaluation
        timer = self.step_timer = StepTimer(window=max(cfg.evaluate_every,
                                                       1))
        epoch_examples = self.model.num_batches(cfg.batch_size) \
            * cfg.batch_size
        t0 = time.time()
        timer.start()
        for epoch in range(self._start_epoch, cfg.epochs + 1):
            sums = self._finish_epoch(epoch, self.train_epoch())
            history.append(sums)
            timer.tick()
            if self._stop():
                self.checkpoint(epoch)
                log.warning('Stopped by SIGTERM at epoch %d; %s', epoch,
                            f'state saved to {cfg.save_path}' if cfg.save
                            else 'nothing saved (--no_save)')
                return True
            if epoch % cfg.evaluate_every:
                continue
            eps = epoch_examples / timer.mean_s if timer.mean_s else 0.0
            log.info('Epoch %d: %s (%.0f examples/s, %.1fs)', epoch,
                     self._format_components(sums), eps, time.time() - t0)
            self.evaluate(epoch)
            self.checkpoint(epoch)
            timer.start()       # the evaluation is no epoch's time
            if metrics_mod.early_stop(self.metrics_logger):
                log.warning('Early stopping triggerred at epoch %d', epoch)
                return True
        return False

    # ------------------------------------------------------------------
    # checkpoints and resume

    def checkpoint(self, epoch: int):
        """``latest_checkpoint``, ``resume_state`` and, when this epoch's
        eval reached a new best, ``best`` (``.pkl``, or ``.orbax`` with
        ``--ckpt_backend orbax``).  On a mesh the pickle backend has every
        rank gather and rank 0 write; the cooperative backend has every
        rank write its own rows of the tables (no gather)."""
        if not self.cfg.save:
            return
        ck = self._checkpointer
        shards = ck.cooperative
        state = {'params': params_to_jax(self.model.param_tree(shards)),
                 'epoch': epoch, 'model': self.cfg.model}
        payload = (self.resume_payload(epoch, shards)
                   if self.cfg.resume_state else None)
        if not (shards or self.primary):
            return
        ck.save_latest(self.cfg.save_path, state)
        if payload is not None:
            ck.save_resume(self.cfg.save_path, payload)
        first = self.metrics_logger[self.metrics_names[0]]
        if len(first) and first[:, 0].max() == first[-1][0] \
                and epoch == self._last_eval_epoch:
            log.info('Updating best model at epoch %d', epoch)
            ck.promote_best(self.cfg.save_path)

    def _generators(self) -> dict[str, torch.Generator]:
        """The generators a resume restores: the sampler's, the salts'
        and a model's own (``model.generator``, where it has one)."""
        gens = {'sampler': self.generator, 'salt': self.salt_generator}
        if self.model.generator is not None:
            gens['model'] = self.model.generator
        return gens

    def _whole_rows(self, name: str) -> int | None:
        """On a mesh, the real row count of a row-sharded parameter (the
        tables); None for a parameter every rank holds whole."""
        if self.model.mesh is None:
            return None
        return {'user_emb': self.model.n_users,
                'item_emb': self.model.n_items}.get(name)

    def _adam_entries(self) -> list[tuple[str, torch.nn.Parameter]]:
        """``(name, parameter)`` of every parameter Adam steps, in the
        order of ``named_parameters`` (the order of ``param_tree``)."""
        stepped = {id(p) for g in self.optimizer.param_groups
                   for p in g['params']}
        return [(n, p) for n, p in self.model.named_parameters()
                if id(p) in stepped]

    def resume_payload(self, epoch: int, shards: bool = False) -> dict:
        """What ``resume`` needs beside ``latest_checkpoint``: the JAX
        package's ``epoch``, ``metrics`` and ``config``; where it keeps
        ``key_data`` and ``opt_leaves``, the two generators' states and the
        Adam state, one entry per stepped parameter (whole tables on a
        mesh: every rank must call it; with ``shards`` the tables' moments
        are this rank's rows, ``weights.RowShard``s)."""
        def arr(t):
            return t.detach().to('cpu').numpy().copy()

        adam = {}
        for i, (name, p) in enumerate(self._adam_entries()):
            st = self.optimizer.state.get(p, {})
            entry = {'name': name}
            for key in ('exp_avg', 'exp_avg_sq'):
                if key in st:
                    n = self._whole_rows(name)
                    if n is None:
                        entry[key] = arr(st[key])
                    elif shards:
                        entry[key] = RowShard(st[key].detach(), n)
                    else:
                        entry[key] = arr(self.model.gathered(st[key], n))
            if 'step' in st:
                entry['step'] = float(st['step'])
            adam[str(i)] = entry
        return {
            'epoch': np.int64(epoch),
            'generators': {name: arr(g.get_state())
                           for name, g in self._generators().items()},
            'adam': adam,
            'metrics': {m: self.metrics_logger[m]
                        for m in self.metrics_names},
            'config': {f: getattr(self.cfg, f)
                       for f in RESUME_CONFIG_FIELDS},
        }

    def resume(self, run_dir: str):
        """Restore params, Adam state, generators, metrics history and the
        epoch from a run directory; ``fit`` then continues at the next
        epoch as the uninterrupted run would have.  Refuses files of two
        epochs, another trajectory config, other Adam shapes and the JAX
        package's resume state (its RNG keys have no torch counterpart)."""
        log.info('Resuming from %s', run_dir)
        ck = self._checkpointer
        if not os.path.isdir(run_dir):
            raise ValueError(f'--resume takes a run directory (got '
                             f'{run_dir!r}); to warm-start from a single '
                             'checkpoint file use --load')
        if not os.path.exists(os.path.join(run_dir, ck.resume_name)):
            raise FileNotFoundError(
                f'no {ck.resume_name} in {run_dir}: the run was saved with '
                '--no_resume_state; use --load for a tables-only warm start')
        state = ck.load(os.path.join(run_dir, ck.latest_name))
        rs = ck.load_resume(run_dir)
        if 'adam' not in rs and 'key_data' in rs and 'opt_leaves' in rs:
            raise ValueError(
                f'{run_dir} holds the JAX package\'s resume state (key_data '
                'and opt_leaves, no adam): the JAX package\'s RNG keys '
                'cannot be continued in torch, so --resume of a JAX run is '
                f'refused; --load {run_dir} warm-starts from the same run')
        if int(rs['epoch']) != int(state.get('epoch', -1)):
            raise ValueError(
                f'resume_state (epoch {int(rs["epoch"])}) does not match '
                f'{ck.latest_name} (epoch {state.get("epoch")}): the run was '
                'interrupted mid-checkpoint; use --load to warm-start from '
                'the params instead')
        diffs = {f: (v, getattr(self.cfg, f, None))
                 for f, v in rs.get('config', {}).items()
                 if getattr(self.cfg, f, None) != v}
        if diffs:
            detail = ', '.join(f'{f}: saved={a!r} vs {b!r}'
                               for f, (a, b) in sorted(diffs.items()))
            raise ValueError(
                f"--resume requires the saving run's trajectory-relevant "
                f'config; differing: {detail}. Use --load to warm-start '
                'with new hyperparameters.')
        restored = self._restored_adam(rs['adam'])
        params = params_from_jax(state['params'], self.model.n_users,
                                 self.model.n_items, self.model.device)
        self.model.load_params(params)
        self.optimizer.state.clear()
        for p, st in restored.items():
            self.optimizer.state[p] = st
        for name, g in self._generators().items():
            g.set_state(torch.from_numpy(rs['generators'][name]))
        self.metrics_logger = {m: np.asarray(rs['metrics'][m])
                               for m in self.metrics_names}
        self._start_epoch = int(rs['epoch']) + 1
        log.info('Resumed at epoch %d', self._start_epoch - 1)

    def _restored_adam(self, saved: dict) -> dict:
        """``{parameter: Adam state}`` from the payload's ``adam``, this
        rank's rows of the tables' moments; raises on another count or
        shape of entries."""
        entries = self._adam_entries()
        if len(saved) != len(entries):
            raise ValueError(f'--resume requires the same model config as '
                             f'the saving run ({len(saved)} optimizer '
                             f'entries saved, {len(entries)} now)')
        restored = {}
        for i, (name, p) in enumerate(entries):
            got = saved[str(i)]
            n = self._whole_rows(name)
            shape = tuple(p.shape) if n is None else (n, *p.shape[1:])
            st = {}
            for key in ('exp_avg', 'exp_avg_sq'):
                if key not in got:
                    continue
                if tuple(got[key].shape) != shape:
                    raise ValueError(
                        f'--resume requires the same model config as the '
                        f'saving run (optimizer {key} of {name}: saved '
                        f'{tuple(got[key].shape)} vs current {shape})')
                v = torch.from_numpy(got[key]).to(p.device, p.dtype)
                st[key] = v if n is None else self.model.local_rows(
                    v, p.shape[0]).clone()
            if 'step' in got:
                st['step'] = torch.tensor(got['step'], dtype=torch.float32)
            if st:
                restored[p] = st
        return restored

    # ------------------------------------------------------------------
    # evaluation and serving

    def evaluate(self, epoch: int | None = None) -> dict[str, list[float]]:
        """Metrics of the current tables over the test users; also kept in
        ``last_metrics``."""
        self._last_eval_epoch = epoch
        on_evaluate = getattr(self.model, 'on_evaluate', None)
        if on_evaluate is not None:
            on_evaluate()
        preds, _ = self._predict_users(self.data.test_users)
        results = metrics_mod.calculate_metrics(
            preds, self.data.true_test, self.k)
        log.info(' ' * 11 + ''.join(f'@{i:<6}' for i in self.k))
        for m in self.metrics_names:
            self.metrics_logger[m] = np.append(
                self.metrics_logger[m], [results[m]], axis=0)
            log.info('%-11s' % m + ' '.join(f'{v:.4f}' for v in results[m]))
        self.last_metrics = results
        return results

    def _predict_users(self, users: np.ndarray):
        """Top-max(k) over the catalogue for ``users``: numpy (n, max_k)
        indices and values.  One propagation, then batches of
        ``batch_size`` users; all in the span ``serve.request``, whose
        inputs are the request's sequence number and its cohort size."""
        bs, max_k = self.cfg.batch_size, max(self.k)
        users = np.asarray(users, np.int64)
        self._requests += 1
        with span('serve.request', (self._requests, len(users))):
            with span('serve.upload'):
                users = torch.as_tensor(users, device=self.model.device)
            vals, idx = [], []
            with torch.no_grad():
                with span('serve.propagate'):
                    reprs = self.model.scoring_reprs()
                for start in range(0, len(users), bs):
                    with span('serve.retrieve'):
                        v, i = self.model.topk_for_users(
                            reprs, users[start:start + bs], max_k)
                    vals.append(v)
                    idx.append(i)
            if not vals:
                return (np.zeros((0, max_k), np.int64),
                        np.zeros((0, max_k), np.float32))
            with span('serve.fetch'):
                return (torch.cat(idx).cpu().numpy(),
                        torch.cat(vals).cpu().numpy())

    def predict(self, users, save: bool = False, with_scores: bool = False):
        """Ranked items (+ scores) for a user id list; with ``save``,
        ``predictions.tsv`` in the run directory."""
        users = np.asarray(list(users), dtype=np.int64)
        idx, vals = self._predict_users(users)
        predictions = idx.tolist()
        scores = np.round(vals, 4).tolist()
        if save and self.primary:
            item_ids, user_ids = self.data.item_id_map, self.data.user_id_map
            os.makedirs(self.cfg.save_path, exist_ok=True)
            out = os.path.join(self.cfg.save_path, 'predictions.tsv')
            with open(out, 'w', newline='', encoding='utf-8') as f:
                writer = csv.writer(f, delimiter='\t', lineterminator='\n')
                writer.writerow(['user_id', 'y_pred', 'scores'])
                for u, row, s in zip(users.tolist(), predictions, scores):
                    writer.writerow([user_ids[u],
                                     str([item_ids[i] for i in row]),
                                     str(s)])
            log.info('Predictions are saved in `%s`', out)
        if with_scores:
            return predictions, scores
        return predictions

    def export_reprs(self) -> dict[str, str]:
        """Write the eval-mode propagated tables as ``users_repr.npy`` and
        ``items_repr.npy`` in the run directory, and for a model with
        ``supports_fused_sharded_topk`` (the LTR heads but the tree heads,
        the concat scorers) its collapsed factors
        (``ltr_user_factors.npy``, ``ltr_item_factors
        .npy``, ``ltr_bias.npy``: head scores are ``u @ i.T + bias``);
        returns {name: path}."""
        model = self.model
        with torch.no_grad():
            users_repr, items_repr = model.representation()
            arrays = {
                'users_repr': model.gathered(users_repr, model.n_users),
                'items_repr': model.gathered(items_repr, model.n_items)}
            if getattr(model, 'supports_fused_sharded_topk', False):
                # the whole users and, on a mesh, this rank's items, as
                # scoring_reprs gives them
                users = torch.arange(model.n_users, device=model.device)
                u_cat, i_cat, bias = model.fused_catalog_inputs(
                    (arrays['users_repr'], items_repr), users)
                arrays.update(
                    ltr_user_factors=u_cat,
                    ltr_item_factors=model.gathered(i_cat, model.n_items),
                    ltr_bias=bias)
        paths = {}
        for name, arr in arrays.items():
            path = os.path.join(self.cfg.save_path, f'{name}.npy')
            if self.primary:
                os.makedirs(self.cfg.save_path, exist_ok=True)
                np.save(path, arr.detach().cpu().numpy())
            paths[name] = path
        log.info('Exported representations to %s: %s', self.cfg.save_path,
                 ', '.join(sorted(arrays)))
        return paths

    def load(self, load_path: str):
        """Warm-start from a checkpoint: the parameters it has are copied
        in (``load_params``), then evaluated; the metrics history is
        reset."""
        log.info('Loading model %s', load_path)
        state = self._checkpointer.load(load_path)
        params = params_from_jax(state['params'], self.model.n_users,
                                 self.model.n_items, self.model.device)
        self.model.load_params(params)
        log.info('Performance of the loaded model:')
        self.evaluate()
        self.metrics_logger = {m: np.zeros((0, len(self.k)))
                               for m in self.metrics_names}
