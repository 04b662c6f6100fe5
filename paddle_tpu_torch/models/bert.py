"""The BERT/ERNIE encoder (paddle_tpu/models/bert.py; BASELINE.json's
"ERNIE-3.0 / BERT-base pretraining" config): embeddings with a LayerNorm,
nn.TransformerEncoder of post-norm nn.TransformerEncoderLayers (exact GELU,
dropout), a tanh pooler, and the pretraining (MLM + NSP) and
sequence-classification heads. Attention goes through
F.scaled_dot_product_attention: on a card, the CUDA flash kernels (D = 64
at the bert-base widths), attention dropout inside them, an
``attention_mask`` of the form [B, 1, 1, S] as their key-padding bias.
"""
from __future__ import annotations

from dataclasses import dataclass

from .. import nn
from ..core.dtype import dtype_name
from ..nn import functional as F
from ..ops.creation import arange, zeros_like

__all__ = ["BertConfig", "BertEmbeddings", "BertModel",
           "BertForPretraining", "BertForSequenceClassification",
           "BERT_PRESETS"]


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dropout: float = 0.1
    dtype: str = "bfloat16"


BERT_PRESETS = {
    "bert-base": BertConfig(),
    "bert-large": BertConfig(hidden_size=1024, num_hidden_layers=24,
                             num_attention_heads=16, intermediate_size=4096),
    "debug": BertConfig(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                        num_attention_heads=2, intermediate_size=128,
                        max_position_embeddings=128, dropout=0.0,
                        dtype="float32"),
}


class BertEmbeddings(nn.Layer):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(
            cfg.max_position_embeddings, cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(
            cfg.type_vocab_size, cfg.hidden_size)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size,
                                       epsilon=cfg.layer_norm_eps)
        self.dropout = nn.Dropout(cfg.dropout)

    def forward(self, input_ids, token_type_ids=None):
        s = input_ids.shape[1]
        pos = arange(s, dtype="int64").unsqueeze(0)
        if token_type_ids is None:
            token_type_ids = zeros_like(input_ids)
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(pos)
             + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(x))


class BertModel(nn.Layer):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.config = cfg
        self.embeddings = BertEmbeddings(cfg)
        layer = nn.TransformerEncoderLayer(
            cfg.hidden_size, cfg.num_attention_heads, cfg.intermediate_size,
            dropout=cfg.dropout, activation="gelu",
            layer_norm_eps=cfg.layer_norm_eps)
        self.encoder = nn.TransformerEncoder(layer, cfg.num_hidden_layers)
        self.pooler = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        x = self.embeddings(input_ids, token_type_ids)
        # the encoder's own compute dtype (bf16 after amp.decorate O2),
        # read off its weights (bert.py:80-86): x is cast to it. The port's
        # dtypes are torch's, which print as "torch.bfloat16", so the
        # reference's str(p.dtype) test reads Paddle's name instead.
        enc_dtype = next((p.dtype for p in self.encoder.parameters()
                          if dtype_name(p.dtype) in ("bfloat16", "float16")),
                         None)
        if enc_dtype is not None and enc_dtype != x.dtype:
            x = x.astype(enc_dtype)
        x = self.encoder(x, attention_mask)
        pooled = F.tanh(self.pooler(x[:, 0]))
        return x, pooled


class BertForPretraining(nn.Layer):
    """MLM + NSP heads."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.config = cfg
        self.bert = BertModel(cfg)
        self.mlm_transform = nn.Sequential(
            nn.Linear(cfg.hidden_size, cfg.hidden_size),
            nn.GELU(),
            nn.LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_eps),
        )
        self.mlm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size)
        self.nsp_head = nn.Linear(cfg.hidden_size, 2)

    def forward(self, input_ids, token_type_ids=None, mlm_labels=None,
                nsp_labels=None):
        seq, pooled = self.bert(input_ids, token_type_ids)
        mlm_logits = self.mlm_head(self.mlm_transform(seq))
        nsp_logits = self.nsp_head(pooled)
        if mlm_labels is not None:
            loss = F.cross_entropy(
                mlm_logits.reshape([-1, self.config.vocab_size]),
                mlm_labels.reshape([-1]), ignore_index=-100)
            if nsp_labels is not None:
                loss = loss + F.cross_entropy(nsp_logits,
                                              nsp_labels.reshape([-1]))
            return loss
        return mlm_logits, nsp_logits


class BertForSequenceClassification(nn.Layer):
    def __init__(self, cfg: BertConfig, num_classes=2):
        super().__init__()
        self.bert = BertModel(cfg)
        self.dropout = nn.Dropout(cfg.dropout)
        self.classifier = nn.Linear(cfg.hidden_size, num_classes)

    def forward(self, input_ids, token_type_ids=None, labels=None):
        _, pooled = self.bert(input_ids, token_type_ids)
        logits = self.classifier(self.dropout(pooled))
        if labels is not None:
            return F.cross_entropy(logits, labels.reshape([-1]))
        return logits
