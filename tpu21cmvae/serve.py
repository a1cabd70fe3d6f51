"""Minimal production serving layer: a warm emulator behind HTTP.

The reference is driven from notebooks only (SURVEY.md §1); deploying it
means ~40 ms-per-signal `Model.predict` calls in-process. Here a saved
checkpoint loads once, the predict program compiles once per batch
bucket (:class:`~tpu21cmvae.parallel.inference.ShardedEmulator` pads
ragged request sizes to a bounded set of compiled shapes), and any
client speaks JSON over HTTP — no JAX, no Python version coupling, no
TensorFlow.

    python -m tpu21cmvae serve pretrained/direct_synthetic.npz \
        --port 8765 --warmup 1024

Endpoints (all JSON):

* ``GET  /health``     → model kind, parameter labels, device, bins.
* ``POST /predict``    ``{"params": [[7 floats], …]}`` → ``{"signals":
  [[451 floats], …]}`` (mK).
* ``POST /loglik``     ``{"params": …, "obs": [451 floats],
  "noise_var": scalar-or-[451]}`` → ``{"loglik": [floats]}``. Likelihood
  programs are cached per (obs, noise_var) so an MCMC driver pays one
  compile per observation, not per request — and zero compiles if the
  observation was pre-warmed (``warmup_loglik`` / ``--warmup-obs``).
  Served at the model's default tier: near-mode |ΔlogL| ≤ ~0.43 on the
  flagship (safe for MH acceptance, not for absolute log-density reads
  — ``DirectEmulator.loglik_fn`` documents the contract tier).
  ``/loglik``, ``/sample``, ``/fit`` and ``/evidence`` all additionally
  accept ``"fg_terms": K`` (+ optional ``"fg_basis": "linlog"|
  "powerlaw"|"polynomial"``, ``"fg_prior_var": v``) to marginalize a
  K-term linear foreground out of the likelihood analytically — zero
  per-sample cost (:mod:`tpu21cmvae.foregrounds`) — and
  ``"noise_scale_marginal": true`` (+ optional ``"noise_alpha"``/
  ``"noise_beta"`` InvGamma prior) to marginalize the absolute noise
  LEVEL too, treating ``noise_var`` as shape only
  (:mod:`tpu21cmvae.noisescale`; composes with the foreground spec);
  programs cache per (obs, noise spec) value as usual.
* ``POST /sample``     ``{"obs": …, "noise_var": …, "sampler": "mh"|
  "pt", "n_walkers": …, "n_steps": …, "target_ess": …, …}`` → posterior
  summary JSON (moments, 16/50/84 quantiles, ESS, R-hat, diagnostics,
  an evenly-thinned sample block; PT adds swap rates + ladder). The
  ENTIRE chain runs on device inside the request; chain programs are
  cached on the same per-observation likelihood closure ``/loglik``
  uses, so repeat requests with the same chain sizes compile nothing
  (:meth:`EmulatorService.sample`). Long chains: pass ``"async": true``
  for 202 + a job id polled at ``GET /result/<id>`` (the chain no
  longer pins the handler thread or client connection), and/or
  ``"busy_timeout_s": N`` to get 503 + retry hint instead of queueing
  behind a busy device.
* ``POST /fit``        ``{"obs": …, "noise_var": …, "n_starts": …,
  "n_steps": …, "top": …}`` → maximum-likelihood parameters (multi-
  start Adam ascent; best row + ranked top block). Ascent programs are
  cached on the same likelihood closure — repeat fits compile nothing.
* ``POST /evidence``   ``{"obs": …, "noise_var": …, "method":
  "laplace"|"smc"|"nested", …}`` → ``log Z`` for model screening
  (Laplace: deterministic and fastest, + MAP/covariance; smc:
  adaptive tempered anneal, replication error bar + posterior block;
  nested: robust and slowest, + posterior block). Served
  at the model's default tier — see the tier caveat on
  :meth:`EmulatorService.evidence`.
* ``POST /gof``        ``{"obs": …, "noise_var": …, "draws": [[7
  floats], …]}`` → posterior predictive goodness-of-fit of the draws
  (e.g. a ``/sample`` response's ``samples`` block) against the
  observation: p-value, q/dof, worst-bin z (one batched predict).

``/sample``, ``/fit``, ``/evidence`` and ``/gof`` all honor
``"async": true`` → 202 + ``GET /result/<id>`` (bounded job queue,
single worker — long device work pins neither a handler thread nor the
client connection).

Device work is serialized by an explicit lock (one warm program
saturates the chip at mega-batch sizes — docs/PERF.md; scale-out is
more replicas behind a load balancer), but the server itself is
threading: ``GET /health`` answers instantly even while a long device
call (or a cold compile) is in flight.
"""

from __future__ import annotations

import hashlib
import json
import queue
import threading
import uuid
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

#: Largest accepted POST body. 16 MB of JSON is ~10^5 predict rows —
#: far above any sane per-request batch (bigger batches should stream as
#: multiple requests anyway); everything larger is rejected with 413
#: before the single-threaded server reads or compiles anything.
MAX_BODY_BYTES = 16 << 20


class DeviceBusyError(RuntimeError):
    """The device lock could not be acquired within the caller's
    ``busy_timeout_s`` — mapped to HTTP 503 + retry hint so a short
    request is never silently starved behind a long chain (round-3
    VERDICT #8)."""


class EmulatorService:
    """The request-independent core: warm model + program caches.

    Split from the HTTP plumbing so it is directly testable and
    embeddable (e.g. behind a different transport).
    """

    def __init__(self, model, mesh=None, loglik_cache: int = 8):
        from tpu21cmvae.parallel.inference import ShardedEmulator

        self.model = model
        self._sharded = ShardedEmulator.for_model(model, mesh=mesh)
        self._mesh = self._sharded.mesh
        # values: (ShardedEmulator for /loglik, raw loglik closure for
        # /sample — chain programs live on the closure)
        self._loglik: "OrderedDict[str, tuple]" = OrderedDict()
        self._loglik_cap = loglik_cache
        # device dispatch is serialized on purpose; holding the lock only
        # around device work lets /health answer during long calls
        self._device_lock = threading.Lock()
        # the LRU itself is mutated from every handler thread
        # (ThreadingHTTPServer): get/move_to_end in a lookup can race an
        # eviction in another thread's commit — guard ALL dict ops
        self._cache_lock = threading.Lock()
        # async sampling jobs (202 + /result/<id>): one worker thread
        # (device work is serialized anyway), bounded queue, bounded
        # retained history — started lazily on first submission
        self._jobs: "OrderedDict[str, dict]" = OrderedDict()
        self._job_lock = threading.Lock()
        self._job_queue: "queue.Queue" = queue.Queue(maxsize=32)
        self._job_worker: Optional[threading.Thread] = None
        self.JOB_HISTORY = 64

    # -- async sampling jobs ---------------------------------------------

    #: endpoints that honor ``"async": true`` (every long-running
    #: device-bound POST — the starvation argument is identical)
    ASYNC_KINDS = ("sample", "evidence", "fit", "gof")

    def submit_sample(self, obs, noise_var=1.0, **opts) -> str:
        """Queue a ``/sample`` request for background execution —
        see :meth:`submit_job`."""
        return self.submit_job("sample", obs, noise_var, **opts)

    def submit_job(self, kind: str, obs, noise_var=1.0, **opts) -> str:
        """Queue a long device-bound request (``kind`` in
        :data:`ASYNC_KINDS`) for background execution and return a job
        id immediately — the async pattern for work that would
        otherwise hold an HTTP worker thread (and its client
        connection) for its whole device wall time: a long chain, a
        nested-sampling evidence, a big multi-start fit. Poll
        :meth:`job_status`. Raises :class:`DeviceBusyError` when the
        job queue is full (bounded so clients cannot enqueue unbounded
        device work). Validation happens in the worker: a bad request
        surfaces as the job's ``error`` field."""
        if kind not in self.ASYNC_KINDS:
            raise ValueError(
                f"async kind must be one of {self.ASYNC_KINDS}; "
                f"got {kind!r}"
            )
        job_id = uuid.uuid4().hex[:16]
        rec = {"status": "queued"}
        with self._job_lock:
            self._jobs[job_id] = rec
            while len(self._jobs) > self.JOB_HISTORY:
                # drop the oldest FINISHED job; never evict live ones
                for k, r in self._jobs.items():
                    if r["status"] in ("done", "error"):
                        del self._jobs[k]
                        break
                else:
                    break
        try:
            self._job_queue.put_nowait(
                (job_id, kind, obs, noise_var, opts)
            )
        except queue.Full:
            with self._job_lock:
                del self._jobs[job_id]
            raise DeviceBusyError(
                f"job queue full ({self._job_queue.maxsize} pending); "
                "retry after a /result poll shows capacity"
            ) from None
        with self._job_lock:
            # start-check under the lock: two concurrent submissions
            # must not each spawn a worker (two workers would run two
            # jobs' device calls concurrently and complete jobs out of
            # submission order)
            if self._job_worker is None or not self._job_worker.is_alive():
                self._job_worker = threading.Thread(
                    target=self._job_loop, daemon=True
                )
                self._job_worker.start()
        return job_id

    def job_status(self, job_id: str) -> dict:
        """``{"status": "queued"|"running"}`` while in flight, the full
        :meth:`sample` payload plus ``status="done"`` on success, or
        ``{"status": "error", "error": ...}``. Unknown ids raise
        ``KeyError`` (→ HTTP 400)."""
        with self._job_lock:
            if job_id not in self._jobs:
                raise KeyError(f"unknown job id {job_id!r}")
            return dict(self._jobs[job_id])

    def _job_loop(self):
        while True:
            job_id, kind, obs, noise_var, opts = self._job_queue.get()
            with self._job_lock:
                self._jobs[job_id]["status"] = "running"
            try:
                out = getattr(self, kind)(obs, noise_var, **opts)
                out["status"] = "done"
            except Exception as e:  # surfaced to the poller, job by job
                out = {"status": "error",
                       "error": f"{type(e).__name__}: {e}"}
            with self._job_lock:
                self._jobs[job_id] = out

    def _bucket_sizes(self, batch_sizes, up_to: Optional[int]):
        if up_to is None:
            return batch_sizes
        sizes, b = [], self._sharded.quantum
        while b < up_to:
            sizes.append(b)
            b *= 2
        return sizes + [b]

    def warmup(self, batch_sizes=(1, 256, 1024), up_to: Optional[int] = None
               ) -> None:
        """Precompile predict buckets. ``up_to=N`` compiles EVERY bucket
        a request of ≤ N rows can hit (quantum·2^k), so no client ever
        pays a cold 20-60 s compile mid-request."""
        with self._device_lock:
            self._sharded.warmup(
                self._bucket_sizes(batch_sizes, up_to),
                n_params=self.model.config.n_params,
            )

    def warmup_loglik(
        self,
        specs,
        batch_sizes=(1, 256, 1024),
        up_to: Optional[int] = None,
    ) -> None:
        """Precompile LIKELIHOOD programs for known observations.

        ``specs``: iterable of ``(obs, noise_var)`` pairs (``noise_var``
        scalar or per-bin). Without this, the first ``POST /loglik`` for
        each new observation builds and compiles a fresh program while
        the client waits — seconds per program on a cold start. An MCMC
        driver's observation is known before sampling starts, so warm it
        here (CLI: ``--warmup-obs FILE``); warmed entries count against
        the LRU cache like any other."""
        sizes = self._bucket_sizes(batch_sizes, up_to)
        for spec in specs:
            obs, nv = spec if isinstance(spec, tuple) else (spec, 1.0)
            key, entry = self._loglik_lookup(
                np.asarray(obs, np.float32), np.asarray(nv, np.float32)
            )
            with self._device_lock:
                entry[0].warmup(sizes, n_params=self.model.config.n_params)
            self._loglik_commit(key, entry)

    def health(self) -> dict:
        return {
            "status": "ok",
            "kind": type(self.model).__name__,
            "n_params": self.model.config.n_params,
            "n_bins": self.model.config.n_bins,
            "par_labels": list(getattr(self.model, "par_labels", [])),
            "devices": [str(d) for d in self._mesh.devices.ravel()],
        }

    def predict(self, params) -> np.ndarray:
        with self._device_lock:
            return np.atleast_2d(self._sharded(np.asarray(params, np.float32)))

    def _noise_spec(self, noise_var, opts):
        """Request noise spec → per-bin array, a foreground-
        marginalized noise model when the request carries ``fg_terms``
        (+ optional ``fg_basis``/``fg_prior_var`` — see
        :mod:`tpu21cmvae.foregrounds`), and/or a noise-LEVEL-
        marginalized spec when it carries ``noise_scale_marginal: true``
        (+ optional ``noise_alpha``/``noise_beta`` —
        :mod:`tpu21cmvae.noisescale`; composes with the foreground
        spec). Rebuilt per request (host-side milliseconds); the
        program cache keys on its VALUE, so repeat requests with the
        same spec hit the same compiled programs."""
        fg_terms = opts.pop("fg_terms", None)
        fg_basis = opts.pop("fg_basis", "linlog")
        fg_prior_var = opts.pop("fg_prior_var", None)
        scale_marginal = bool(opts.pop("noise_scale_marginal", False))
        noise_alpha = opts.pop("noise_alpha", None)
        noise_beta = opts.pop("noise_beta", None)
        nv = np.asarray(noise_var, np.float32)
        if fg_terms is not None:
            nv = self.model.marginalize_foreground(
                nv, n_terms=int(fg_terms), basis=fg_basis,
                prior_var=fg_prior_var,
            )
        if scale_marginal:
            from tpu21cmvae.noisescale import marginalize_noise_scale

            nv = marginalize_noise_scale(
                nv, alpha=noise_alpha, beta=noise_beta,
            )
        elif noise_alpha is not None or noise_beta is not None:
            raise ValueError(
                "noise_alpha/noise_beta require noise_scale_marginal"
            )
        return nv

    def _loglik_lookup(self, obs: np.ndarray, nv):
        """Validated (obs, noise spec) → (cache key, ShardedEmulator) —
        built cold when absent; the caller commits after first
        success. ``nv``: per-bin array, a
        :class:`~tpu21cmvae.foregrounds.MarginalizedNoise`, or a
        :class:`~tpu21cmvae.noisescale.ScaleMarginalNoise`."""
        from tpu21cmvae.foregrounds import MarginalizedNoise
        from tpu21cmvae.noisescale import ScaleMarginalNoise
        from tpu21cmvae.parallel.inference import ShardedEmulator

        n_bins = self.model.config.n_bins
        if obs.shape != (n_bins,):
            raise ValueError(
                f"obs must be a flat list of {n_bins} floats; got shape "
                f"{obs.shape}"
            )
        base = nv.base if isinstance(nv, ScaleMarginalNoise) else nv
        if isinstance(base, MarginalizedNoise):
            if base.whiten.shape != (n_bins, n_bins):
                raise ValueError(
                    f"MarginalizedNoise built for {base.whiten.shape[0]} "
                    f"bins; the model has {n_bins}"
                )
        else:
            shape = np.shape(base)
            if shape not in ((), (n_bins,)):
                raise ValueError(
                    f"noise_var must be a scalar or {n_bins} per-bin "
                    f"values; got shape {shape}"
                )
        mk = getattr(nv, "memo_key", None)
        if callable(mk):
            nv_key = repr(mk()).encode()
        else:
            nv_key = nv.tobytes() + repr(nv.shape).encode()
        key = hashlib.sha256(obs.tobytes() + nv_key).hexdigest()
        with self._cache_lock:
            entry = self._loglik.get(key)
            if entry is not None:
                self._loglik.move_to_end(key)
        if entry is None:
            # memo=False: this LRU is the sole owner of the closure, so
            # its eviction (cap ``loglik_cache``) really frees the
            # compiled programs — the model-level memo would pin them
            fn = self.model.loglik_fn(obs, nv, memo=False)
            entry = (
                ShardedEmulator(fn, self.model.params, mesh=self._mesh),
                fn,
            )
        return key, entry

    def _loglik_commit(self, key: str, entry) -> None:
        with self._cache_lock:
            if key not in self._loglik:
                self._loglik[key] = entry
                if len(self._loglik) > self._loglik_cap:
                    self._loglik.popitem(last=False)  # evict oldest

    def loglik(self, params, obs, noise_var=1.0, **opts) -> np.ndarray:
        nv = self._noise_spec(noise_var, opts)
        if opts:
            raise ValueError(f"unknown loglik options: {sorted(opts)}")
        key, entry = self._loglik_lookup(np.asarray(obs, np.float32), nv)
        with self._device_lock:
            out = np.atleast_1d(entry[0](np.asarray(params, np.float32)))
        # cache only after a successful call, so a request that fails at
        # trace time cannot poison the key for later valid requests
        self._loglik_commit(key, entry)
        return out

    #: request caps: bound what one /sample request can make the device
    #: chew on (a chain is n_steps sequential mega-batches) and how much
    #: JSON it can ask back
    SAMPLE_MAX_WALKERS = 8192
    SAMPLE_MAX_STEPS = 5000
    SAMPLE_MAX_RUNGS = 256
    SAMPLE_MAX_RETURN = 4096

    def sample(self, obs, noise_var=1.0, **opts) -> dict:
        """On-device posterior sampling as a service: one request, one
        chain program, a JSON posterior summary back.

        The likelihood closure is the SAME cached object ``/loglik``
        uses, and the chain programs live on it
        (:func:`tpu21cmvae.sampling._chain_program`) — so repeated
        ``/sample`` requests for a known observation with the same
        chain sizes re-trace NOTHING: each request is one device call
        after the first. Options: ``sampler`` (``"mh"`` default, or
        ``"pt"`` with ``n_rungs`` for multimodal posteriors),
        ``n_walkers``/``n_steps``/``n_warmup``/``thin``/``seed``,
        ``bounds`` (``[[lo, hi], …]``, defaults to the 21cmGEM-shaped
        box), ``target_ess`` (mh only — chunked chains until the
        minimum per-parameter ESS reaches it), ``max_samples`` (cap on
        returned posterior rows, default 1,000). Returns summary
        moments, per-parameter quantiles/ESS/R-hat, diagnostics, and an
        evenly-thinned sample block.
        """
        from tpu21cmvae.sampling import sample_mh, sample_pt, sample_to_ess

        noise_var = self._noise_spec(noise_var, opts)
        sampler = opts.pop("sampler", "mh")
        max_samples = int(opts.pop("max_samples", 1000))
        if not 1 <= max_samples <= self.SAMPLE_MAX_RETURN:
            raise ValueError(
                f"max_samples must be in [1, {self.SAMPLE_MAX_RETURN}]"
            )
        # None = wait for the device indefinitely (the pre-round-4
        # behavior); a number = give up with 503 after that many
        # seconds so a short request is not starved behind a long chain
        busy_timeout_s = opts.pop("busy_timeout_s", None)
        if busy_timeout_s is not None:
            busy_timeout_s = float(busy_timeout_s)
            if busy_timeout_s < 0:
                raise ValueError("busy_timeout_s must be >= 0")
        kwargs = dict(
            n_walkers=int(opts.pop("n_walkers", 1024)),
            n_steps=int(opts.pop("n_steps", 300)),
            n_warmup=int(opts.pop("n_warmup", 200)),
            thin=int(opts.pop("thin", 10)),
            seed=int(opts.pop("seed", 0)),
        )
        if kwargs["n_walkers"] > self.SAMPLE_MAX_WALKERS:
            raise ValueError(
                f"n_walkers capped at {self.SAMPLE_MAX_WALKERS}"
            )
        if max(kwargs["n_steps"], kwargs["n_warmup"]) > self.SAMPLE_MAX_STEPS:
            raise ValueError(
                f"n_steps/n_warmup capped at {self.SAMPLE_MAX_STEPS}"
            )
        if kwargs["thin"] <= 0:
            raise ValueError("thin must be positive")
        bounds = opts.pop("bounds", None)
        if bounds is not None:
            bounds = np.asarray(bounds, np.float64)
            if bounds.shape != (self.model.config.n_params, 2):
                raise ValueError(
                    f"bounds must be ({self.model.config.n_params}, 2)"
                )
            kwargs["bounds"] = bounds
        if sampler == "pt":
            n_rungs = int(opts.pop("n_rungs", 32))
            if n_rungs > self.SAMPLE_MAX_RUNGS:
                raise ValueError(
                    f"n_rungs capped at {self.SAMPLE_MAX_RUNGS}"
                )
            fn_run, extra = sample_pt, {"n_rungs": n_rungs}
        elif sampler == "mh":
            if "target_ess" in opts:
                fn_run = sample_to_ess
                extra = {
                    "target_ess": float(opts.pop("target_ess")),
                    "max_chunks": min(int(opts.pop("max_chunks", 25)), 50),
                }
            else:
                fn_run, extra = sample_mh, {}
        else:
            raise ValueError(
                f"sampler must be 'mh' or 'pt' over HTTP; got {sampler!r}"
            )
        if opts:
            raise ValueError(f"unknown sample options: {sorted(opts)}")

        key, entry = self._loglik_lookup(
            np.asarray(obs, np.float32), noise_var
        )
        if busy_timeout_s is None:
            self._device_lock.acquire()
        elif not self._device_lock.acquire(timeout=busy_timeout_s):
            raise DeviceBusyError(
                f"device busy for > {busy_timeout_s:.1f}s (a long chain "
                "or cold compile is in flight); retry, raise "
                "busy_timeout_s, or submit with async=true and poll "
                "/result/<id>"
            )
        try:
            res = fn_run(
                entry[1], self.model.params, mesh=self._mesh,
                **kwargs, **extra,
            )
        finally:
            self._device_lock.release()
        self._loglik_commit(key, entry)

        flat = res.flat
        if flat.shape[0] == 0:  # thin too coarse for the step count
            raise ValueError(
                "no stored samples: raise n_steps or lower thin"
            )
        stride = max(1, flat.shape[0] // max_samples)
        labels = list(getattr(self.model, "par_labels", []))
        out = {
            "sampler": sampler,
            "par_labels": labels,
            "mean": flat.mean(0).tolist(),
            "std": flat.std(0).tolist(),
            "quantiles": {
                q: np.percentile(flat, 100 * q, axis=0).tolist()
                for q in (0.16, 0.5, 0.84)
            },
            # need ≥4 kept steps for autocorrelation estimates; short
            # smoke chains still get moments + samples. NaN (a zero-
            # variance parameter under the rank-normalized estimator)
            # → None per entry: literal NaN is not valid JSON and
            # strict clients reject the whole payload
            "ess": (
                [None if not np.isfinite(v) else float(v)
                 for v in res.ess()]
                if res.chain.shape[0] >= 4 else None),
            # tail ESS (Vehtari 2021 §4.3) backs the quantile rows
            # above the way bulk ESS backs the mean; NaN→None per
            # parameter when no chain toggled that tail indicator
            "ess_tail": (
                [None if not np.isfinite(v) else float(v)
                 for v in res.ess_tail()]
                if res.chain.shape[0] >= 4 else None),
            "rhat": (res.rhat().tolist()
                     if res.chain.shape[0] >= 4 else None),
            "accept_rate": float(np.mean(res.accept_rate)),
            "n_samples": int(flat.shape[0]),
            "samples": flat[::stride][:max_samples].tolist(),
        }
        if sampler == "pt":
            out["swap_rate"] = res.swap_rate.tolist()
            out["betas"] = res.betas.tolist()
        return out

    def gof(self, obs, noise_var=1.0, **opts) -> dict:
        """Posterior predictive goodness-of-fit as a service
        (:func:`tpu21cmvae.calibration.goodness_of_fit`): did the
        assumed signal+noise model generate this observation? Options:
        ``draws`` (REQUIRED — posterior rows in raw parameter units,
        e.g. the ``samples`` block a ``/sample`` response returns),
        ``max_draws`` (subsample cap, default 512), ``seed``, plus the
        usual noise-marginalization options (``fg_terms`` …;
        ``noise_scale_marginal`` is refused — the level absorbs any
        overall misfit). One batched predict; returns the p-value,
        q/dof, and the worst-bin diagnostic."""
        from tpu21cmvae.calibration import goodness_of_fit

        noise_var = self._noise_spec(noise_var, opts)
        draws = opts.pop("draws", None)
        if draws is None:
            raise ValueError(
                "gof needs 'draws': posterior rows in raw parameter "
                "units (e.g. the samples block /sample returns)"
            )
        max_draws = int(opts.pop("max_draws", 512))
        seed = int(opts.pop("seed", 0))
        if opts:
            raise ValueError(f"unknown gof options: {sorted(opts)}")
        res = goodness_of_fit(
            self.model, np.asarray(obs, np.float64), noise_var,
            np.asarray(draws, np.float32), max_draws=max_draws,
            seed=seed,
        )
        worst = int(np.argmax(np.abs(res.bin_z)))
        return {
            "p_value": float(res.p_value),
            "dof": float(res.dof),
            "q_over_dof": float(np.mean(res.q) / res.dof),
            "n_draws": int(res.q.shape[0]),
            "max_bin_z": float(np.abs(res.bin_z).max()),
            "worst_bin": worst,
            "summary": res.summary(),
        }

    def _check_bounds(self, opts):
        bounds = opts.pop("bounds", None)
        if bounds is None:
            return {}
        bounds = np.asarray(bounds, np.float64)
        if bounds.shape != (self.model.config.n_params, 2):
            raise ValueError(
                f"bounds must be ({self.model.config.n_params}, 2)"
            )
        return {"bounds": bounds}

    def fit(self, obs, noise_var=1.0, **opts) -> dict:
        """Maximum-likelihood parameter fit as a service: multi-start
        Adam ascent (:func:`tpu21cmvae.sampling.fit_map`) over the
        cached per-observation likelihood — the ascent program is
        cached on the same closure ``/loglik`` and ``/sample`` use, so
        repeat fits compile nothing. Options: ``n_starts`` (default
        1,024, capped at ``SAMPLE_MAX_WALKERS``), ``n_steps`` (default
        300, capped at ``SAMPLE_MAX_STEPS``), ``seed``, ``bounds``,
        ``top`` (how many ranked starts to return, default 16)."""
        from tpu21cmvae.sampling import fit_map, valgrad_from_loglik

        noise_var = self._noise_spec(noise_var, opts)
        kwargs = dict(
            n_starts=int(opts.pop("n_starts", 1024)),
            n_steps=int(opts.pop("n_steps", 300)),
            seed=int(opts.pop("seed", 0)),
        )
        top = int(opts.pop("top", 16))
        if kwargs["n_starts"] > self.SAMPLE_MAX_WALKERS:
            raise ValueError(
                f"n_starts capped at {self.SAMPLE_MAX_WALKERS}"
            )
        if kwargs["n_steps"] > self.SAMPLE_MAX_STEPS:
            raise ValueError(f"n_steps capped at {self.SAMPLE_MAX_STEPS}")
        if not 1 <= top <= min(kwargs["n_starts"],
                               self.SAMPLE_MAX_RETURN):
            raise ValueError("top out of range")
        kwargs.update(self._check_bounds(opts))
        if opts:
            raise ValueError(f"unknown fit options: {sorted(opts)}")
        key, entry = self._loglik_lookup(
            np.asarray(obs, np.float32), noise_var
        )
        with self._device_lock:
            res = fit_map(
                valgrad_from_loglik(entry[1]), self.model.params,
                mesh=self._mesh, **kwargs,
            )
        self._loglik_commit(key, entry)
        order = np.argsort(-np.nan_to_num(res.logp, nan=-np.inf))[:top]
        return {
            "par_labels": list(getattr(self.model, "par_labels", [])),
            "best": res.best.tolist(),
            "best_logp": float(res.best_logp),
            "top": res.params[order].tolist(),
            "top_logp": res.logp[order].tolist(),
        }

    #: /evidence caps (nested): live points and constrained-MH steps
    EVIDENCE_MAX_LIVE = 4096
    EVIDENCE_MAX_MH = 64

    def evidence(self, obs, noise_var=1.0, **opts) -> dict:
        """Bayesian evidence as a service. ``method="laplace"``
        (default over HTTP — deterministic, the fastest), ``"smc"``
        (adaptive tempered anneal — replication ``logz_err``,
        posterior particles included; the screening sweet spot), or
        ``"nested"`` (robust, the slowest; ``n_live``/``n_mh``
        capped).

        Tier caveat: the served likelihood is the model's DEFAULT tier
        (near-mode |ΔlogL| ≈ 0.43 on the flagship), which bounds the
        absolute accuracy of any served ``logz`` — fine for screening;
        for publication-grade Bayes factors run
        ``model.log_evidence`` in-process, which pins the exact tier
        for Laplace (``DirectEmulator.loglik_fn`` documents the
        contract tier)."""
        noise_var = self._noise_spec(noise_var, opts)
        method = opts.pop("method", "laplace")
        seed = int(opts.pop("seed", 0))
        bkw = self._check_bounds(opts)
        key, entry = self._loglik_lookup(
            np.asarray(obs, np.float32), noise_var
        )
        if method == "laplace":
            from tpu21cmvae.sampling import laplace_evidence

            n_starts = int(opts.pop("n_starts", 4096))
            n_steps = int(opts.pop("n_steps", 2000))
            if n_starts > self.SAMPLE_MAX_WALKERS:
                raise ValueError(
                    f"n_starts capped at {self.SAMPLE_MAX_WALKERS}"
                )
            if n_steps > self.SAMPLE_MAX_STEPS:
                raise ValueError(
                    f"n_steps capped at {self.SAMPLE_MAX_STEPS}"
                )
            if opts:
                raise ValueError(
                    f"unknown evidence options: {sorted(opts)}"
                )
            with self._device_lock:
                res = laplace_evidence(
                    entry[1], self.model.params, n_starts=n_starts,
                    n_steps=n_steps, seed=seed, mesh=self._mesh, **bkw,
                )
            self._loglik_commit(key, entry)
            return {
                "method": "laplace",
                "logz": float(res.logz),
                "pd": bool(res.pd),
                "map_params": res.map_params.tolist(),
                "map_logp": float(res.map_logp),
                "cov": res.cov.tolist(),
            }
        if method == "smc":
            from tpu21cmvae.sampling import sample_smc

            n_particles = int(opts.pop("n_particles", 4096))
            n_mh = int(opts.pop("n_mh", 8))
            if n_particles > self.SAMPLE_MAX_WALKERS:
                raise ValueError(
                    f"n_particles capped at {self.SAMPLE_MAX_WALKERS}"
                )
            if n_mh > self.EVIDENCE_MAX_MH:
                raise ValueError(f"n_mh capped at {self.EVIDENCE_MAX_MH}")
            max_samples = int(opts.pop("max_samples", 1000))
            if not 1 <= max_samples <= self.SAMPLE_MAX_RETURN:
                raise ValueError(
                    f"max_samples must be in [1, {self.SAMPLE_MAX_RETURN}]"
                )
            if opts:
                raise ValueError(
                    f"unknown evidence options: {sorted(opts)}"
                )
            with self._device_lock:
                res = sample_smc(
                    entry[1], self.model.params,
                    n_particles=n_particles, n_mh=n_mh, seed=seed,
                    mesh=self._mesh, **bkw,
                )
            self._loglik_commit(key, entry)
            rng = np.random.default_rng(seed)
            take = rng.permutation(res.final.shape[0])[:max_samples]
            return {
                "method": "smc",
                "logz": float(res.logz),
                "logz_err": float(res.logz_err),
                "n_stages": int(res.n_stages),
                "accept_rate": float(res.accept_rate.mean()),
                "posterior": res.final[take].tolist(),
            }
        if method != "nested":
            raise ValueError(
                f"method must be 'laplace', 'smc' or 'nested' over "
                f"HTTP; got {method!r}"
            )
        from tpu21cmvae.nested import nested_sampling

        n_live = int(opts.pop("n_live", 1024))
        n_mh = int(opts.pop("n_mh", 16))
        if n_live > self.EVIDENCE_MAX_LIVE:
            raise ValueError(f"n_live capped at {self.EVIDENCE_MAX_LIVE}")
        if n_mh > self.EVIDENCE_MAX_MH:
            raise ValueError(f"n_mh capped at {self.EVIDENCE_MAX_MH}")
        max_samples = int(opts.pop("max_samples", 1000))
        if not 1 <= max_samples <= self.SAMPLE_MAX_RETURN:
            raise ValueError(
                f"max_samples must be in [1, {self.SAMPLE_MAX_RETURN}]"
            )
        if opts:
            raise ValueError(f"unknown evidence options: {sorted(opts)}")
        with self._device_lock:
            res = nested_sampling(
                entry[1], self.model.params, n_live=n_live, n_mh=n_mh,
                seed=seed, mesh=self._mesh, **bkw,
            )
        self._loglik_commit(key, entry)
        return {
            "method": "nested",
            "logz": float(res.logz),
            "logz_err": float(res.logz_err),
            "h": float(res.h),
            "ess": float(res.ess),
            "truncated": bool(res.truncated),
            "posterior": res.posterior(max_samples, seed=seed).tolist(),
        }


def _make_handler(service: EmulatorService):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # device dispatch serializes on the service lock, so keep-alive
        # buys nothing: close after every response, and bound reads so a
        # half-open connection can't pin its handler thread forever
        timeout = 30

        def log_message(self, *args):  # quiet by default
            pass

        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(body)
            self.close_connection = True

        def _device_post(self, kind, req):
            """Shared body for the long device-bound POSTs: every one
            honors ``"async": true`` (202 + /result/<id> poll — the
            request no longer pins this handler thread or the client
            connection for its device wall time)."""
            obs = req.pop("obs")
            nv = req.pop("noise_var", 1.0)
            if req.pop("async", False):
                job_id = service.submit_job(kind, obs, nv, **req)
                self._reply(202, {
                    "job_id": job_id,
                    "result_path": f"/result/{job_id}",
                })
            else:
                self._reply(200, getattr(service, kind)(obs, nv, **req))

        def do_GET(self):
            if self.path == "/health":
                self._reply(200, service.health())
            elif self.path.startswith("/result/"):
                try:
                    self._reply(
                        200, service.job_status(self.path[len("/result/"):])
                    )
                except KeyError as e:
                    self._reply(400, {"error": str(e)})
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                if n > MAX_BODY_BYTES:
                    # bound what one client can make the single-threaded
                    # server read + compile (each new batch bucket costs
                    # a cold compile)
                    self._reply(413, {
                        "error": f"request body {n} bytes exceeds the "
                        f"{MAX_BODY_BYTES}-byte limit; split the batch"
                    })
                    return
                req = json.loads(self.rfile.read(n) or b"{}")
                if self.path == "/predict":
                    out = service.predict(req["params"])
                    self._reply(200, {"signals": out.tolist()})
                elif self.path == "/loglik":
                    params = req.pop("params")
                    obs = req.pop("obs")
                    nv = req.pop("noise_var", 1.0)
                    out = service.loglik(params, obs, nv, **req)
                    self._reply(200, {"loglik": out.tolist()})
                elif self.path == "/sample":
                    self._device_post("sample", req)
                elif self.path == "/fit":
                    self._device_post("fit", req)
                elif self.path == "/evidence":
                    self._device_post("evidence", req)
                elif self.path == "/gof":
                    self._device_post("gof", req)
                else:
                    self._reply(404, {"error": f"unknown path {self.path}"})
            except DeviceBusyError as e:
                # the device is legitimately busy — tell the client to
                # come back rather than holding its connection
                self._reply(503, {"error": str(e), "retry_after_s": 5})
            except (KeyError, ValueError, TypeError) as e:
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:  # device/runtime failures → JSON 500,
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                # not a dropped socket the client can't interpret

    return Handler


def make_server(
    model, host: str = "127.0.0.1", port: int = 8765, mesh=None
) -> ThreadingHTTPServer:
    """Build (but do not start) the HTTP server; ``serve_forever()`` it,
    or drive it from a thread in tests. ``port=0`` picks a free port
    (``server.server_address[1]``). Threading server + per-service
    device lock: ``/health`` stays responsive during long device calls."""
    service = EmulatorService(model, mesh=mesh)
    server = ThreadingHTTPServer((host, port), _make_handler(service))
    server.daemon_threads = True
    server.service = service  # expose for warmup / introspection
    return server


def load_obs_specs(path: str):
    """``--warmup-obs`` file → ``[(obs, noise_var), …]``.

    ``.json``: one object or a list of objects
    ``{"obs": [n_bins floats], "noise_var": scalar-or-[n_bins]}``
    (``noise_var`` defaults to 1.0). ``.npz``: array ``obs`` of shape
    (n_bins,) or (k, n_bins) plus optional ``noise_var``.
    """
    if path.endswith(".npz"):
        blob = np.load(path)
        obs = np.atleast_2d(np.asarray(blob["obs"], np.float32))
        nv = (
            np.asarray(blob["noise_var"], np.float32)
            if "noise_var" in blob
            else np.float32(1.0)
        )
        if nv.ndim == 2:
            nvs = nv  # (k, n_bins): per-observation per-bin
        elif nv.ndim == 1 and nv.shape[0] == obs.shape[1]:
            # (n_bins,): one per-bin noise curve shared by every obs
            nvs = np.broadcast_to(nv, (obs.shape[0],) + nv.shape)
        elif nv.ndim == 1 and nv.shape[0] == obs.shape[0]:
            nvs = nv  # (k,): one scalar per observation
        elif nv.ndim == 0:
            nvs = np.broadcast_to(nv, (obs.shape[0],))
        else:
            raise ValueError(
                f"noise_var shape {nv.shape} matches neither the "
                f"{obs.shape[0]} observations nor the {obs.shape[1]} "
                "bins"
            )
        return [(o, n) for o, n in zip(obs, nvs)]
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, dict):
        doc = [doc]
    return [
        (
            np.asarray(d["obs"], np.float32),
            np.asarray(d.get("noise_var", 1.0), np.float32),
        )
        for d in doc
    ]


def main(
    model_path: str,
    host: str,
    port: int,
    warmup: Optional[int],
    warmup_obs: Optional[str] = None,
):
    from tpu21cmvae.models import load_model
    from tpu21cmvae.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    model = load_model(model_path)
    server = make_server(model, host=host, port=port)
    if warmup:
        print(f"warming ALL predict buckets up to {warmup} rows...")
        server.service.warmup(up_to=warmup)
    if warmup_obs:
        specs = load_obs_specs(warmup_obs)
        print(f"warming likelihood programs for {len(specs)} "
              f"observation(s) from {warmup_obs}...")
        server.service.warmup_loglik(specs, up_to=warmup or None)
    host, port = server.server_address[:2]
    print(f"serving {model_path} on http://{host}:{port} "
          "(GET /health, POST /predict, POST /loglik)")
    server.serve_forever()
