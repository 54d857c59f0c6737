"""Viterbi decoding and its parameter builders."""
