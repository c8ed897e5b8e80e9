from .event_tokens import (  # noqa: F401
    TokenOffset,
    VOCAB_SIZE,
    PAD_ID,
    EOS_ID,
    BAR_ID,
    build_event2word,
    build_word2event,
    event2word,
    word2event,
)
from .meta_codec import MetaEncoder, encode_meta, decode_meta_value  # noqa: F401
