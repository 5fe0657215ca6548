"""Core automaton construction: trie building and table compilation."""

from .automaton import compile_trie, empty_automaton
from .tables import CompiledAutomaton
from .trie import TrieBuilder

__all__ = ["TrieBuilder", "CompiledAutomaton", "compile_trie", "empty_automaton"]
