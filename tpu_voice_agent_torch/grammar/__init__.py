from .fsm import DeviceFSM, TokenFSM, fsm_advance, fsm_row
from .hf_tokenizer import HFTokenizer, load_hf_tokenizer
from .intent_grammar import build_fsm_for, build_intent_fsm, default_tokenizer, intent_regex
from .jsonschema import schema_to_regex
from .regexlang import DFA, compile_regex
from .tokenizer import Tokenizer, train_bpe

__all__ = [
    "DFA",
    "DeviceFSM",
    "HFTokenizer",
    "TokenFSM",
    "Tokenizer",
    "build_fsm_for",
    "build_intent_fsm",
    "compile_regex",
    "default_tokenizer",
    "fsm_advance",
    "fsm_row",
    "intent_regex",
    "load_hf_tokenizer",
    "schema_to_regex",
    "train_bpe",
]
