"""LSTM text classification (counterpart of
``paddle_tpu/models/lstm_textcls.py``; reference config
benchmark/paddle/rnn/rnn.py: embedding, stacked LSTMs, last step, fc
softmax)."""
from __future__ import annotations

from .. import layers


def lstm_text_classification(data, vocab_size=30000, num_classes=2,
                             emb_dim=128, hidden_size=128, lstm_num=1):
    """``data`` is an int token tensor [B, T] (lod_level=1: feed its
    ``<name>@LEN`` lengths with padded batches)."""
    net = layers.embedding(data, size=[vocab_size, emb_dim])
    for _ in range(lstm_num):
        proj = layers.fc(net, size=hidden_size * 4, num_flatten_dims=2)
        net, _ = layers.dynamic_lstm(proj, size=hidden_size * 4)
    last = layers.sequence_last_step(net)
    return layers.fc(last, size=num_classes, act="softmax")


def stacked_lstm_net(data, vocab_size, num_classes=2, emb_dim=128,
                     hidden_dim=512, stacked_num=3):
    """The book's understand_sentiment stacked_lstm_net: LSTMs of
    alternating direction over the concatenated previous projection and
    LSTM output, max-pooled over time."""
    emb = layers.embedding(data, size=[vocab_size, emb_dim])
    fc1 = layers.fc(emb, size=hidden_dim, num_flatten_dims=2)
    lstm1, _ = layers.dynamic_lstm(fc1, size=hidden_dim)
    inputs = [fc1, lstm1]
    for i in range(2, stacked_num + 1):
        fc = layers.fc(layers.concat(inputs, axis=2), size=hidden_dim,
                       num_flatten_dims=2)
        lstm, _ = layers.dynamic_lstm(fc, size=hidden_dim,
                                      is_reverse=(i % 2) == 0)
        inputs = [fc, lstm]
    fc_last = layers.sequence_pool(inputs[0], "max")
    lstm_last = layers.sequence_pool(inputs[1], "max")
    return layers.fc([fc_last, lstm_last], size=num_classes, act="softmax")
