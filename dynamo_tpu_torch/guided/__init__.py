"""Guided (grammar-constrained) decoding: the port's own copy of the
reference's compiler (dynamo_tpu/guided, numpy only).

Requests ask for it with ``sampling.guided`` (the preprocessor's mapping
of guided_json / guided_regex / guided_choice / response_format): a
grammar compiles to a byte DFA (regex.py, schema.py), then to
token-class-compressed tables over the tokenizer's vocabulary
(tokens.py). The engine holds each guided slot's tables on the device and
masks and steps the FSM inside every sampling epilogue (engine/sampling.py
``guided_mask`` / ``guided_step``); the FSM state rides the decode
horizon's carry, so guided rows keep their horizons and CUDA graphs.
"""

from .regex import Dfa, RegexError, compile_regex, escape_literal
from .schema import (
    SchemaError,
    choice_regex,
    guided_regex_pattern,
    json_value_regex,
    schema_to_regex,
)
from .tokens import TokenTables, build_token_tables, vocab_bytes_from_tokenizer

__all__ = [
    "Dfa",
    "RegexError",
    "SchemaError",
    "TokenTables",
    "build_token_tables",
    "choice_regex",
    "compile_regex",
    "escape_literal",
    "guided_regex_pattern",
    "json_value_regex",
    "schema_to_regex",
    "vocab_bytes_from_tokenizer",
]
