"""Beam-search generation (counterpart of ``paddle_tpu/layers/generation.py:
76-205``, without ``attention_with_cache``, which comes with the
decode-serving slice).

The decode loop is one ``beam_search`` op holding the user's per-step
sub-block (the machinery of the ``rnn`` op): beams are flattened into the
batch ([B*K] rows), expansion is one top-k over [B, K*V], and the
backtrace reads the recorded (parent, token) tables.  Finished beams are
frozen by masking, so every step has the same shapes
(``ops/generation_ops.py``)::

    bs = BeamSearchDecoder(beam_size=4, bos_id=0, eos_id=1, max_len=16,
                           vocab_size=V)
    with bs.step():
        tok = bs.token()                  # [B*K] int32 current tokens
        state = bs.memory(init=dec_init)  # [B*K, H] (tiled to beams)
        ... compute probs [B*K, V] from (tok, state) ...
        bs.update_memory(state, new_state)
        bs.set_probs(probs)
    ids, scores, lens = bs()              # [B, K, max_len], [B, K], [B, K]
"""
from __future__ import annotations

import contextlib
import itertools

from ..core import unique_name
from ..layer_helper import LayerHelper

__all__ = ["BeamSearchDecoder", "register_beam_hook", "get_beam_hook"]

# Per-step hooks live in a registry so the op's attr stays a
# JSON-serializable name.
_STEP_HOOKS = {}
_HOOK_COUNTER = itertools.count()


def register_beam_hook(name, fn):
    """Register a per-step hook under ``name``.  The decoder calls it at
    each step as ``fn(t, info)`` with ``info = {"scores": [B, K, V]
    candidate log-probs, "tokens": [B, K] current tokens, "finished":
    [B, K] bool}``, all tensors on the decoder's device; it returns
    ``None`` or an additive [B, K, V] bias tensor applied before the top-k
    (``-inf`` entries prune candidates, e.g. to force an early eos).
    Torch ops only: a captured or exported decoder holds what it does."""
    _STEP_HOOKS[name] = fn
    return name


def get_beam_hook(name):
    if name not in _STEP_HOOKS:
        raise KeyError(
            f"beam step hook {name!r} is not registered in this process; "
            f"call register_beam_hook(name, fn) before running the decoder")
    return _STEP_HOOKS[name]


class BeamSearchDecoder:
    def __init__(self, beam_size, bos_id, eos_id, max_len, vocab_size,
                 length_penalty=0.0, step_hook=None, name=None):
        self.helper = LayerHelper("beam_search", name=name)
        self.program = self.helper.main_program
        self.beam_size = beam_size
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.max_len = max_len
        self.vocab_size = vocab_size
        self.length_penalty = length_penalty
        if callable(step_hook):
            # a process-local counter, not unique_name (which callers
            # reset between builds): a kept program's hook never rebinds
            step_hook = register_beam_hook(
                f"__beam_hook_{next(_HOOK_COUNTER)}", step_hook)
        self.step_hook = step_hook      # registry name or None
        self.memories = {}      # step name -> [init var, update name]
        self.contexts = {}      # step name -> parent var
        self.token_var = None
        self.probs_var = None
        self.sub_block = None
        self.parent_block = None
        self.outputs = None

    @contextlib.contextmanager
    def step(self):
        self.parent_block = self.program.current_block()
        self.sub_block = self.program.create_block()
        try:
            yield
        finally:
            self.program.rollback()
            self._complete()

    def token(self):
        """Current token ids, one per live beam: int32 [B*K]."""
        if self.token_var is not None:
            raise RuntimeError("BeamSearchDecoder.token() called twice")
        self.token_var = self.sub_block.create_var(
            name=unique_name.generate("beam_token"), dtype="int32",
            shape=(-1,))
        return self.token_var

    def memory(self, init):
        """Per-beam state from a per-sequence init [B, ...]; the op tiles
        it to [B*K, ...]."""
        mem = self.sub_block.create_var(
            name=unique_name.generate("beam_mem"), dtype=init.dtype,
            shape=init.shape)
        self.memories[mem.name] = [init, None]
        return mem

    def context(self, x):
        """A read-only per-sequence tensor [B, ...] (e.g. the encoder's
        outputs); returns its step-block view, tiled to [B*K, ...]."""
        v = self.sub_block.create_var(
            name=unique_name.generate("beam_ctx"), dtype=x.dtype,
            shape=x.shape, lod_level=x.lod_level)
        self.contexts[v.name] = x
        return v

    def update_memory(self, mem, new):
        self.memories[mem.name][1] = new.name

    def set_probs(self, probs):
        """Next-token probabilities [B*K, V] (after the softmax)."""
        self.probs_var = probs

    def _complete(self):
        if self.token_var is None or self.probs_var is None:
            raise RuntimeError("BeamSearchDecoder: the step block must call "
                               "token() and set_probs()")
        ids = self.parent_block.create_var(
            name=unique_name.generate("beam_ids"), dtype="int32",
            shape=(-1, self.beam_size, self.max_len))
        scores = self.parent_block.create_var(
            name=unique_name.generate("beam_scores"), dtype="float32",
            shape=(-1, self.beam_size))
        lens = self.parent_block.create_var(
            name=unique_name.generate("beam_lens"), dtype="int32",
            shape=(-1, self.beam_size))
        mem_names = list(self.memories)
        ctx_names = list(self.contexts)
        self.parent_block.append_op(
            "beam_search",
            inputs={"InitStates": [self.memories[m][0].name
                                   for m in mem_names],
                    "Contexts": [self.contexts[c].name for c in ctx_names]},
            outputs={"Ids": [ids.name], "Scores": [scores.name],
                     "Lens": [lens.name]},
            attrs={
                "sub_block": self.sub_block.idx,
                "token_name": self.token_var.name,
                "probs_name": self.probs_var.name,
                "mem_step_names": mem_names,
                "mem_update_names": [self.memories[m][1]
                                     for m in mem_names],
                "ctx_step_names": ctx_names,
                "beam_size": self.beam_size,
                "bos_id": self.bos_id,
                "eos_id": self.eos_id,
                "max_len": self.max_len,
                "vocab_size": self.vocab_size,
                "length_penalty": self.length_penalty,
                "step_hook": self.step_hook,
            })
        self.outputs = (ids, scores, lens)

    def __call__(self):
        return self.outputs
