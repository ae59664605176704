"""Seq2seq with attention, the training network (counterpart of
``seq2seq_attention`` in ``paddle_tpu/models/seq2seq.py:1-100``, with
the same parameter names, so a scope carries across).

The encoder embeds the source, projects it and runs a GRU over the
padded batch; the decoder is a ``StaticRNN`` whose step attends over
the encoder states by dot product, updates a GRU state and emits a
softmax over the target vocabulary.  ``seq2seq_infer`` runs the same
decoder step inside a ``BeamSearchDecoder`` under the same parameter
names (``:103-129`` of the JAX module), so a trained scope decodes
directly.
"""
from __future__ import annotations

from .. import layers
from ..layers import control_flow
from ..param_attr import ParamAttr


def _p(prefix, name):
    return ParamAttr(name=f"{prefix}.{name}")


def encoder(src, vocab_size, emb_dim=64, hidden_dim=64, prefix="s2s"):
    emb = layers.embedding(src, size=[vocab_size, emb_dim],
                           param_attr=_p(prefix, "src_emb"))
    proj = layers.fc(emb, size=hidden_dim * 3, num_flatten_dims=2,
                     param_attr=_p(prefix, "enc_proj_w"),
                     bias_attr=_p(prefix, "enc_proj_b"))
    return layers.dynamic_gru(proj, size=hidden_dim,
                              param_attr=_p(prefix, "enc_gru_w"),
                              bias_attr=_p(prefix, "enc_gru_b"))


def _attention(state, enc_out, enc_proj):
    """Dot-product attention: state [B, H] against enc_proj [B, T, H]
    gives the context [B, H] over enc_out.  The softmax runs over all
    T; the masked recurrence left enc_out zero past each length."""
    q = layers.unsqueeze(state, [2])                     # [B, H, 1]
    scores = layers.squeeze(layers.matmul(enc_proj, q), [2])   # [B, T]
    w = layers.unsqueeze(layers.softmax(scores), [1])    # [B, 1, T]
    return layers.squeeze(layers.matmul(w, enc_out), [1])


def _encoder_head(src, src_vocab_size, emb_dim, hidden_dim, prefix):
    enc_out = encoder(src, src_vocab_size, emb_dim, hidden_dim, prefix)
    enc_proj = layers.fc(enc_out, size=hidden_dim, num_flatten_dims=2,
                         param_attr=_p(prefix, "att_proj_w"),
                         bias_attr=False)
    dec_init = layers.fc(layers.sequence_last_step(enc_out),
                         size=hidden_dim, act="tanh",
                         param_attr=_p(prefix, "dec_init_w"),
                         bias_attr=_p(prefix, "dec_init_b"))
    return enc_out, enc_proj, dec_init


def _decoder_step(tok_emb, state, enc_out, enc_proj, hidden_dim,
                  tgt_vocab_size, prefix):
    ctx = _attention(state, enc_out, enc_proj)
    gates = layers.fc([tok_emb, ctx], size=hidden_dim * 3,
                      param_attr=[_p(prefix, "dec_gates_w_emb"),
                                  _p(prefix, "dec_gates_w_ctx")],
                      bias_attr=_p(prefix, "dec_gates_b"))
    new_state, _, _ = layers.gru_unit(
        gates, state, size=hidden_dim * 3,
        param_attr=_p(prefix, "dec_gru_w"),
        bias_attr=_p(prefix, "dec_gru_b"))
    probs = layers.fc(new_state, size=tgt_vocab_size, act="softmax",
                      param_attr=_p(prefix, "dec_out_w"),
                      bias_attr=_p(prefix, "dec_out_b"))
    return new_state, probs


def seq2seq_attention(src, tgt, src_vocab_size, tgt_vocab_size,
                      emb_dim=64, hidden_dim=64, prefix="s2s"):
    """Teacher-forced training network: ``src``/``tgt`` are int token
    sequences [B, T] (lod_level 1, fed with ``@LEN``s); returns the
    per-step softmax [B, T, V] over the target vocabulary."""
    enc_out, enc_proj, dec_init = _encoder_head(
        src, src_vocab_size, emb_dim, hidden_dim, prefix)
    tgt_emb = layers.embedding(tgt, size=[tgt_vocab_size, emb_dim],
                               param_attr=_p(prefix, "tgt_emb"))
    rnn = control_flow.StaticRNN()
    with rnn.step():
        step_emb = rnn.step_input(tgt_emb)
        state = rnn.memory(init=dec_init)
        new_state, probs = _decoder_step(step_emb, state, enc_out, enc_proj,
                                         hidden_dim, tgt_vocab_size, prefix)
        rnn.update_memory(state, new_state)
        rnn.step_output(probs)
    return rnn()


def seq2seq_infer(src, src_vocab_size, tgt_vocab_size, emb_dim=64,
                  hidden_dim=64, beam_size=4, bos_id=0, eos_id=1,
                  max_len=16, length_penalty=0.0, prefix="s2s"):
    """Beam-search decoding network sharing parameter names with
    ``seq2seq_attention``; build it in a program of its own and run it
    against the trained scope.  Returns (ids [B, K, max_len], scores
    [B, K], lens [B, K])."""
    from ..layers.generation import BeamSearchDecoder

    enc_out, enc_proj, dec_init = _encoder_head(
        src, src_vocab_size, emb_dim, hidden_dim, prefix)
    bs = BeamSearchDecoder(beam_size=beam_size, bos_id=bos_id, eos_id=eos_id,
                           max_len=max_len, vocab_size=tgt_vocab_size,
                           length_penalty=length_penalty)
    with bs.step():
        tok = bs.token()
        state = bs.memory(init=dec_init)
        enc_out_t = bs.context(enc_out)
        enc_proj_t = bs.context(enc_proj)
        tok_emb = layers.embedding(tok, size=[tgt_vocab_size, emb_dim],
                                   param_attr=_p(prefix, "tgt_emb"))
        new_state, probs = _decoder_step(tok_emb, state, enc_out_t,
                                         enc_proj_t, hidden_dim,
                                         tgt_vocab_size, prefix)
        bs.update_memory(state, new_state)
        bs.set_probs(probs)
    return bs()
