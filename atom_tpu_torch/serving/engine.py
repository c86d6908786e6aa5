"""FCFS continuous-batching text-generation engine
(``atom_tpu/serving/engine.py``), with serial or mixed prefill.

Policy: refill the workset up to ``batch_size``, greedy sampling, fixed output
lengths, per-request latency accounting.  Serial mode: per iteration one
bucketed prefill per newly admitted request and one decode step for the whole
workset.  Mixed mode (``chunk_fn`` given): an admitted request only reserves
its slot; its prompt then rides the following steps in page-size chunks, one
chunk per step beside the workset's decode rows (earliest admitted first), so
running requests keep stepping while another is admitted.  Sampled ids stay
on the device between steps; per step only the page table and the sequence
lengths (and a chunk's ids and table row) go up, one copy each, from pinned
host memory so the host never waits for the device there.

The host blocks on the device exactly where the JAX engine does: on a
prefill's (or a prompt's last chunk's) token before its time-to-first-token
is stamped, on steps where a sequence finishes before ``finish_t`` is
stamped, and once at the end.

LoRA serving (``lora=True``, step functions from
``serving/lora.py::make_lora_step_fns``): a per-slot adapter table, filled
from ``RequestSet.adapter_ids`` at admission and sent up only when it
changes; serial prefill only.  ``native``: True requires the C++ scheduler
(``atom_tpu_torch/native``: page allocation and per-step table assembly),
"auto" uses it if it builds and takes the Python pool otherwise, anything
false is the Python pool; both assign pages in the same order.
"""
from __future__ import annotations

import dataclasses
import subprocess
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from atom_tpu_torch.ops.runtime import resolve_device
from atom_tpu_torch.serving.kvpool import KvPool, SeqKvCache, batch_page_table
from atom_tpu_torch.serving.workload import RequestSet


@dataclasses.dataclass
class TextGenConfig:
    batch_size: int = 32
    page_size: int = 256
    max_seq_len: int = 2048
    prefill_buckets: tuple = (128, 256, 512, 1024)
    # pool sizing: pages for batch_size full-length seqs + slack
    pool_slack_pages: int = 8


@dataclasses.dataclass
class RequestStat:
    prompt_len: int
    output_len: int
    submit_t: float = 0.0
    first_token_t: float = 0.0
    finish_t: float = 0.0

    @property
    def ttft(self) -> float:
        return self.first_token_t - self.submit_t

    @property
    def per_token_latency(self) -> float:
        n = max(self.output_len - 1, 1)
        return (self.finish_t - self.first_token_t) / n


class _ActiveSeq:
    def __init__(self, idx: int, kv: SeqKvCache, out_len: int, stat: RequestStat):
        self.idx = idx
        self.kv = kv
        self.remaining = out_len
        self.stat = stat


def _state_device(state) -> Optional[torch.device]:
    """Device of the first tensor in a state of nested tuples and lists."""
    if isinstance(state, torch.Tensor):
        return state.device
    if isinstance(state, (tuple, list)):
        for item in state:
            dev = _state_device(item)
            if dev is not None:
                return dev
    return None


class TextGenEngine:
    """Drives (prefill_fn, decode_fn) over a request set with continuous
    batching.  The step functions are model-agnostic:

      prefill_fn(state, ids[T], table_row, true_len, slot) -> (token, state)
      decode_fn(state, ids[B], page_table, seq_lens) -> (next_ids[B], state)
      chunk_fn(state, ids[B], page_table, seq_lens, chunk_ids[C], table_row,
               pos0, chunk_len, chunk_slot) -> (next_ids[B], chunk_token, state)

    ``ids``, ``table_row``, ``page_table``, ``seq_lens`` and ``chunk_ids`` are
    int32 tensors on the engine's device, ``true_len``, ``slot``, ``pos0``,
    ``chunk_len`` and ``chunk_slot`` Python ints, ``token`` and
    ``chunk_token`` 0-dim tensors.  ``chunk_fn`` (optional) selects mixed
    scheduling; its chunk size is the page size.  With ``lora=True``,
    ``prefill_fn`` takes a trailing adapter index (int) and ``decode_fn`` the
    per-slot adapters (int32 [B] on the device).  ``state`` is an opaque tree
    owned by the model (for the W4A4 stack: KV pages + hot ring + flush
    counters).  The engine runs on the device its state lies on; a state
    without tensors means the card.
    """

    def __init__(
        self,
        cfg: TextGenConfig,
        pool: KvPool,
        prefill_fn: Callable,
        decode_fn: Callable,
        state,
        chunk_fn: Optional[Callable] = None,
        native: object = False,
        lora: bool = False,
    ):
        # LoRA: the step functions take a trailing adapter argument (an int for
        # a prefill, the per-slot table for a decode step)
        if lora and chunk_fn is not None:
            raise ValueError("the LoRA engine prefills serially: chunk_fn is not wired for adapters")
        self.lora = lora
        self.cfg = cfg
        self.pool = pool
        self.prefill_fn = prefill_fn
        self.decode_fn = decode_fn
        self.chunk_fn = chunk_fn
        self.state = state
        self.device = _state_device(state) or resolve_device(None)
        self.max_pages = -(-cfg.max_seq_len // cfg.page_size)
        # ``native``: True requires the C++ scheduler, "auto" uses it if it
        # builds, anything false (False, None, 0) is the Python pool
        self.nat = None
        if native:
            try:
                from atom_tpu_torch.native import NativeScheduler

                self.nat = NativeScheduler(cfg.batch_size, pool.n_pages, cfg.page_size, self.max_pages)
            except (OSError, subprocess.CalledProcessError):  # no compiler, a failed build or load
                if native is True:
                    raise
        # (bucket, seconds from dispatch to the token on the host) per prefill of the last run
        self.last_prefill_s: List[tuple] = []

    def _bucket(self, t: int) -> int:
        for b in self.cfg.prefill_buckets:
            if t <= b:
                return b
        raise ValueError(f"prompt length {t} exceeds largest prefill bucket")

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """One host-to-device copy that does not make the host wait: the
        pinned staging block is held by PyTorch until the copy has run."""
        t = torch.from_numpy(a)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _table_row(self, slot: int, kv: Optional[SeqKvCache]) -> np.ndarray:
        """A sequence's page-table row, padded with page 0."""
        if self.nat is not None:
            return self.nat.table_row(slot).copy()
        row = np.zeros((self.max_pages,), np.int32)
        row[: len(kv.page_ids)] = kv.page_ids
        return row

    def _release(self, slot: int, kv: Optional[SeqKvCache]) -> None:
        """Return a sequence's pages that no decode step will retire."""
        if self.nat is not None:
            self.nat.release(slot)
        else:
            kv.release()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def run(self, rs: RequestSet, progress: bool = False, record: bool = False) -> dict:
        cfg = self.cfg
        bsz = cfg.batch_size
        state = self.state  # device tree, threaded through the steps
        stats: List[RequestStat] = [
            RequestStat(int(p), int(o)) for p, o in zip(rs.prompt_lens, rs.output_lens)
        ]

        workset: List[Optional[_ActiveSeq]] = [None] * bsz
        # slots in the middle of a chunked prefill (mixed scheduling): slot -> [seq, next position]
        prefilling: dict = {}
        chunk = cfg.page_size  # a chunked prefill appends whole pages
        next_req = 0
        done = 0
        n_req = len(rs)
        # per-slot current token ids live on the device [bsz]
        ids_dev = torch.zeros((bsz,), dtype=torch.int32, device=self.device)
        # per-slot adapter indices (LoRA), sent up when an admission changes them
        slot_adapters = np.zeros((bsz,), np.int32)
        adapters_dev = self._upload(slot_adapters.copy()) if self.lora else None
        nat = self.nat

        tokens = {r: [] for r in range(n_req)} if record else None
        self.last_prefill_s = []

        t_start = time.perf_counter()
        n_decode_steps = 0
        n_mixed_steps = 0  # steps that carried a prefill chunk and at least one decode row
        # host scheduling tax: admission + page/table assembly + retirement
        # bookkeeping, excluding the step functions' dispatch
        host_sched_s = 0.0
        while done < n_req:
            now = time.perf_counter()
            # --- admit new requests into free slots (FCFS) ---
            for slot in range(bsz):
                if workset[slot] is not None or slot in prefilling or next_req >= n_req:
                    continue
                r = next_req
                if nat is not None:
                    got = nat.admit_hold(r, len(rs.prompts[r]), int(rs.output_lens[r]))
                    if got == -2 and not prefilling and not any(workset):
                        raise RuntimeError(f"KV pool exhausted: request {r}'s prompt does not fit the empty pool")
                    if got in (-1, -2):
                        break  # no slot / pool drained: retry next iteration
                    if got == -3:
                        raise ValueError(
                            f"request {r} unservable: prompt ({len(rs.prompts[r])}) + output "
                            f"({int(rs.output_lens[r])}) tokens exceed max_seq_len ({cfg.max_seq_len})"
                        )
                    assert got == slot, f"native slot {got} != python {slot}"
                next_req += 1
                stats[r].submit_t = now
                prompt = rs.prompts[r]
                t_true = len(prompt)
                kv = None if nat is not None else SeqKvCache(self.pool, t_true)
                seq = _ActiveSeq(r, kv, int(rs.output_lens[r]), stats[r])
                if self.chunk_fn is not None:
                    # mixed scheduling: the prompt rides the following steps in
                    # page-size chunks; the slot is reserved now
                    prefilling[slot] = [seq, 0]
                    continue
                bucket = self._bucket(t_true)
                ids = np.zeros((bucket,), np.int32)
                ids[:t_true] = prompt
                table_row = self._table_row(slot, kv)
                t_p = time.perf_counter()
                if self.lora:
                    aid = int(rs.adapter_ids[r]) if rs.adapter_ids is not None else 0
                    if slot_adapters[slot] != aid:
                        slot_adapters[slot] = aid
                        adapters_dev = self._upload(slot_adapters.copy())
                    tok, state = self.prefill_fn(state, self._upload(ids), self._upload(table_row), t_true, slot, aid)
                else:
                    tok, state = self.prefill_fn(state, self._upload(ids), self._upload(table_row), t_true, slot)
                ids_dev[slot] = tok
                # TTFT is stamped on device completion of the prefill (not
                # its dispatch): fetch the produced token first.
                tok_host = int(tok.item())
                stats[r].first_token_t = time.perf_counter()
                self.last_prefill_s.append((bucket, stats[r].first_token_t - t_p))
                if record:
                    tokens[r].append(tok_host)
                seq.remaining -= 1
                if seq.remaining == 0:  # single-token outputs finish here
                    stats[r].finish_t = stats[r].first_token_t
                    self._release(slot, kv)
                    done += 1
                else:
                    if nat is not None:
                        nat.activate(slot, seq.remaining)
                    workset[slot] = seq

            # slots that decode this step (a prefill completing below joins the
            # workset only for the next step: it is not retired or recorded now)
            stepped = [slot for slot in range(bsz) if workset[slot] is not None]
            if not stepped and not prefilling:
                continue

            # --- one step: whole-workset decode (+ one prefill chunk) ---
            t_h = time.perf_counter()
            if nat is not None:
                # extends the stepped slots and retires (frees) those that finish now
                table, lens, _ = nat.decode_step()
                table, lens = table.copy(), lens.copy()  # the scheduler reuses its buffers
            else:
                for slot in stepped:
                    workset[slot].kv.acquire_one()  # extend; allocate page on boundary
                table, lens = batch_page_table([s.kv if s else None for s in workset], self.max_pages)
            table_dev = self._upload(table)
            lens_dev = self._upload(lens)
            host_sched_s += time.perf_counter() - t_h
            if prefilling:
                # FCFS: the next chunk of the earliest admitted prefilling request
                slot_p = next(iter(prefilling))
                seq_p, pos = prefilling[slot_p]
                prompt = rs.prompts[seq_p.idx]
                t_true = len(prompt)
                clen = min(chunk, t_true - pos)
                cids = np.zeros((chunk,), np.int32)
                cids[:clen] = prompt[pos : pos + clen]
                table_row = self._table_row(slot_p, seq_p.kv)
                ids_dev, chunk_tok, state = self.chunk_fn(
                    state, ids_dev, table_dev, lens_dev, self._upload(cids), self._upload(table_row), pos, clen, slot_p
                )
                pos += clen
                if pos >= t_true:  # prompt complete: its first token is produced
                    ids_dev[slot_p] = chunk_tok
                    tok_host = int(chunk_tok.item())  # wait for the device before stamping
                    seq_p.stat.first_token_t = time.perf_counter()
                    if record:
                        tokens[seq_p.idx].append(tok_host)
                    seq_p.remaining -= 1
                    del prefilling[slot_p]
                    if seq_p.remaining == 0:
                        seq_p.stat.finish_t = seq_p.stat.first_token_t
                        self._release(slot_p, seq_p.kv)
                        done += 1
                    else:
                        if nat is not None:
                            nat.activate(slot_p, seq_p.remaining)
                        workset[slot_p] = seq_p
                else:
                    prefilling[slot_p][1] = pos
                if stepped:
                    n_mixed_steps += 1
            elif self.lora:
                ids_dev, state = self.decode_fn(state, ids_dev, table_dev, lens_dev, adapters_dev)
            else:
                ids_dev, state = self.decode_fn(state, ids_dev, table_dev, lens_dev)
            if stepped:
                n_decode_steps += 1

            if record and stepped:
                ids_host = ids_dev.cpu().numpy()
                for slot in stepped:
                    tokens[workset[slot].idx].append(int(ids_host[slot]))
            # Tail-latency truthfulness: when any sequence finishes this step,
            # wait for the step's output before stamping finish_t, so decode
            # p90 reflects device completion, not host dispatch rate.  Steps
            # where nothing finishes stay fully asynchronous.
            if any(workset[s].remaining == 1 for s in stepped):
                self._sync()
            now = time.perf_counter()
            for slot in stepped:
                s = workset[slot]
                s.remaining -= 1
                if s.remaining == 0:
                    s.stat.finish_t = now
                    if s.kv is not None:
                        s.kv.release()  # the native scheduler freed its pages in decode_step
                    workset[slot] = None
                    done += 1
            host_sched_s += time.perf_counter() - now
            if progress and done and done % 8 == 0:
                print(f"  done {done}/{n_req}", flush=True)

        # Execution barrier: everything above is asynchronous; fetch one scalar.
        _ = int(ids_dev.sum().item())
        elapsed = time.perf_counter() - t_start
        self.state = state

        out_tokens = rs.total_output_tokens
        ttfts = np.array([s.ttft for s in stats])
        ptls = np.array([s.per_token_latency for s in stats])
        out = {
            "elapsed_s": elapsed,
            "requests": n_req,
            "decode_steps": n_decode_steps,
            "mixed_steps": n_mixed_steps,
            "total_tokens": rs.total_tokens,
            "output_tokens": out_tokens,
            "throughput_tok_s": rs.total_tokens / elapsed,
            "output_tok_s": out_tokens / elapsed,
            "ttft_avg_s": float(ttfts.mean()),
            "ttft_p90_s": float(np.percentile(ttfts, 90)),
            "decode_ms_per_token_avg": float(ptls.mean() * 1e3),
            "decode_ms_per_token_p90": float(np.percentile(ptls, 90) * 1e3),
            "scheduler": "native" if nat is not None else "python",
            "host_sched_ms_per_step": host_sched_s / max(n_decode_steps, 1) * 1e3,
        }
        if record:
            out["tokens"] = tokens
            out["ttft_per_request"] = [float(s.ttft) for s in stats]
            out["prompt_lens"] = [int(s.prompt_len) for s in stats]
        return out
