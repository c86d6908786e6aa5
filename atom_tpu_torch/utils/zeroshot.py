"""Zero-shot multiple choice by log-likelihood ranking (``atom_tpu/utils/zeroshot.py``).

Every task is ``(context_tokens, [choice_tokens, ...], gold_index)``; the
answer is the choice whose tokens have the highest (length-normalised)
log-probability given the context.  ``synthetic_task`` is a seeded stand-in,
``corpus_cloze_task`` a real-text task over the repository's corpus, and
``hf_task_examples`` reads piqa, arc, boolq, hellaswag or winogrande from a
local HF datasets cache.
"""
from __future__ import annotations

from typing import Callable, Iterable, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def continuation_logprob(logits: torch.Tensor, full_tokens: np.ndarray, ctx_len: int) -> float:
    """Sum of log P(choice tokens | prefix); logits [T, V] of context ++ choice."""
    lp = F.log_softmax(logits.to(torch.float32), dim=-1)
    t = len(full_tokens)
    idx = torch.arange(ctx_len - 1, t - 1, device=lp.device)  # logits[i] predicts token i + 1
    tgt = torch.as_tensor(np.asarray(full_tokens[ctx_len:], np.int64), device=lp.device)
    return float(torch.sum(lp[idx, tgt]))


@torch.no_grad()
def evaluate_multiple_choice(
    forward: Callable[[torch.Tensor], torch.Tensor],  # ids [1, T] -> logits [1, T, V]
    examples: Iterable[Tuple[np.ndarray, Sequence[np.ndarray], int]],
    length_normalize: bool = True,
    device=None,
) -> dict:
    """Accuracy of log-likelihood-ranked answers -> {"acc": float, "n": int};
    ``length_normalize`` divides by the choice's token count."""
    correct = n = 0
    for ctx, choices, gold in examples:
        scores = []
        for ch in choices:
            full = np.concatenate([ctx, ch]).astype(np.int32)
            logits = forward(torch.from_numpy(full[None]).to(device))[0]
            s = continuation_logprob(logits, full, len(ctx))
            if length_normalize:
                s /= max(len(ch), 1)
            scores.append(s)
        correct += int(np.argmax(scores) == gold)
        n += 1
    return {"acc": correct / max(n, 1), "n": n}


def synthetic_task(
    vocab_size: int, n_examples: int = 16, ctx_len: int = 24, choice_len: int = 6, n_choices: int = 4, seed: int = 0
) -> List[Tuple[np.ndarray, List[np.ndarray], int]]:
    """Seeded synthetic multiple-choice task (an offline stand-in)."""
    rng = np.random.Generator(np.random.PCG64(seed))
    out = []
    for _ in range(n_examples):
        ctx = rng.integers(1, vocab_size, ctx_len).astype(np.int32)
        choices = [rng.integers(1, vocab_size, choice_len).astype(np.int32) for _ in range(n_choices)]
        out.append((ctx, choices, int(rng.integers(0, n_choices))))
    return out


def hf_task_examples(task: str, tokenizer, limit: int = 0) -> List[Tuple[np.ndarray, List[np.ndarray], int]]:
    """Zero-shot tasks from a local HF datasets cache: piqa, arc_easy,
    arc_challenge, boolq, hellaswag, winogrande."""
    from datasets import load_dataset

    def tok(s):
        return np.asarray(tokenizer(s, add_special_tokens=False).input_ids, np.int32)

    out = []
    if task == "piqa":
        for ex in load_dataset("piqa", split="validation"):
            out.append((tok(f"Question: {ex['goal']}\nAnswer:"), [tok(" " + ex["sol1"]), tok(" " + ex["sol2"])],
                        int(ex["label"])))
    elif task in ("arc_easy", "arc_challenge"):
        name = "ARC-Easy" if task == "arc_easy" else "ARC-Challenge"
        for ex in load_dataset("ai2_arc", name, split="validation"):
            labels = ex["choices"]["label"]
            if ex["answerKey"] not in labels:
                continue
            out.append((tok(f"Question: {ex['question']}\nAnswer:"), [tok(" " + t) for t in ex["choices"]["text"]],
                        labels.index(ex["answerKey"])))
    elif task == "boolq":
        for ex in load_dataset("boolq", split="validation"):
            out.append((tok(f"{ex['passage']}\nQuestion: {ex['question']}?\nAnswer:"), [tok(" no"), tok(" yes")],
                        int(ex["answer"])))
    elif task == "hellaswag":
        for ex in load_dataset("hellaswag", split="validation"):
            out.append((tok(ex["ctx"]), [tok(" " + e) for e in ex["endings"]], int(ex["label"])))
    elif task == "winogrande":
        for ex in load_dataset("winogrande", "winogrande_xl", split="validation"):
            a, b = ex["sentence"].split("_")
            out.append((tok(a), [tok(ex["option1"] + b), tok(ex["option2"] + b)], int(ex["answer"]) - 1))
    else:
        raise ValueError(f"unknown task {task!r}")
    return out[:limit] if limit else out


def corpus_cloze_task(
    eval_tokens: np.ndarray, n_examples: int = 64, ctx_len: int = 192, choice_len: int = 64, n_choices: int = 4,
    seed: int = 0,
) -> List[Tuple[np.ndarray, List[np.ndarray], int]]:
    """Real-text multiple choice over held-out prose: the true continuation
    of ``ctx_len`` tokens against continuations from other positions."""
    rng = np.random.Generator(np.random.PCG64(seed))
    span = ctx_len + choice_len
    n_tok = len(eval_tokens)
    out = []
    for _ in range(n_examples):
        s = int(rng.integers(0, n_tok - span - 1))
        ctx = eval_tokens[s : s + ctx_len].astype(np.int32)
        true = eval_tokens[s + ctx_len : s + span].astype(np.int32)
        choices = []
        for _ in range(n_choices - 1):
            d = int(rng.integers(0, n_tok - choice_len - 1))
            choices.append(eval_tokens[d : d + choice_len].astype(np.int32))
        gold = int(rng.integers(0, n_choices))
        choices.insert(gold, true)
        out.append((ctx, choices, gold))
    return out
