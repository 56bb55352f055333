"""EMSNet configuration: the paper's multimodal multitask model.

Text encoder (TinyBERT/MobileBERT/BERTBase-class bidirectional
transformer), vitals encoder (RNN/LSTM/GRU), scene encoder (FC over the
object-detection one-hot), concatenation fusion, three headers:
protocol (46-way), medicine type (18-way), quantity (regression).
Defaults are the TinyBERT-GRU-FC combination the paper highlights for
on-device use. Fields and dims match ``repro.configs.emsnet``.
"""
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class EMSNetConfig:
    name: str = "emsnet"
    # text encoder (bidirectional transformer)
    text_encoder: str = "tinybert"        # tinybert | mobilebert | bertbase
    vocab_size: int = 8192
    max_text_len: int = 64
    # vitals encoder
    vitals_encoder: str = "gru"           # rnn | lstm | gru
    n_vitals: int = 6                     # BP, HR, PO, RR, CO2, BG
    vitals_len: int = 30                  # up to 30 vitals per event (NEMSIS)
    vitals_hidden: int = 64
    # scene encoder
    scene_dim: int = 3                    # alcohol / pill / medicine-bottle
    scene_hidden: int = 16
    # tasks
    n_protocols: int = 46                 # paper follows EMSAssist: 46
    n_medicines: int = 18
    # training
    dropout: float = 0.0
    dtype: str = "float32"
    # text attention through the flash kernel (key-padding mask from the
    # PAD suffix). On by default: it is the port's serving path. False
    # keeps the materialised einsum attention of the reference.
    use_flash_text: bool = True
    # with use_flash_text, run the natural (B, S) path through the
    # segment-masked kernel, S padded to a flash_block multiple
    flash_segments: bool = False
    flash_block: int = 8

    @property
    def text_dims(self) -> Tuple[int, int, int, int]:
        """(layers, d_model, heads, d_ff) for the text encoder."""
        return {
            "microbert": (2, 64, 4, 128),      # CPU-test tier (not in paper)
            "tinybert": (4, 312, 12, 1200),
            "mobilebert": (24, 128, 4, 512),
            "bertbase": (12, 768, 12, 3072),
        }[self.text_encoder]

    @property
    def feature_dims(self):
        """|F_T|, |F_V|, |F_I| — concatenated into F_C."""
        return {
            "text": self.text_dims[1],
            "vitals": self.vitals_hidden,
            "scene": self.scene_hidden,
        }


def config(**kw) -> EMSNetConfig:
    return EMSNetConfig(**kw)


def tiny(**kw) -> EMSNetConfig:
    """Fast CPU-test variant."""
    base = dict(vocab_size=256, max_text_len=16, vitals_len=8,
                vitals_hidden=16, scene_hidden=8)
    base.update(kw)
    return EMSNetConfig(**base)
