"""Seqlock-style write-completeness markers for the shm token ring: the
port's copy of ``tpuserver/shm_ring.py``.

The shm response ring delivers each generation step as an 8-byte slot
(int32 TOKEN + fp32 LOGPROB) that the client reads after the
descriptor-only event names its offset.  The slot itself carries no
write-completeness marker: a reader racing the writer (or reading a lane
the ring already lapped) can observe a torn or stale slot and deliver a
silently wrong token.

This module is the one definition of the optional per-slot **seq
word** that closes that hole, shared by the writer (the llama model's
ring writer) and readers.  A request opting in passes
``shm_ring_seq_base`` — the byte offset of a parallel array of ``slots``
4-byte words in the same region — and the writer brackets every payload
write seqlock-style:

1. stamp ``begin_word(seq)`` (odd — write in progress),
2. write the 8-byte payload slot,
3. stamp ``commit_word(seq)`` (even — payload for ``seq`` committed).

In a CUDA region each of the three is a host-to-device copy that has
completed before the next starts, so the order holds in device memory
as it does in host memory.

A reader accepts the payload only when the seq word equals
``commit_word(seq)`` for the seq it expects; anything else — the odd
in-progress word, a stale word from an earlier lap, zeros from a
never-written slot — is a torn/stale read.  The event still carries
the in-band TOKEN/LOGPROB tensors whenever the seq lane is active, so
a torn reader falls back to the in-band payload instead of surfacing
a wrong token; each fallback is counted in a process-wide count
(:func:`torn_total`).

Word encoding: ``2*seq + 1`` = write of ``seq`` in progress, ``2*seq
+ 2`` = ``seq`` committed.  Zero (a fresh region) never matches any
commit word, so an unwritten slot always reads as stale.
"""

import struct
import threading

__all__ = [
    "SEQ_WORD_BYTES", "begin_word", "commit_word", "seq_word_offset",
    "pack_word", "unpack_word", "slot_committed", "note_torn",
    "torn_total",
]

#: bytes per seq word: one little-endian uint32 per ring slot
SEQ_WORD_BYTES = 4

_WORD = struct.Struct("<I")
_WORD_MOD = 1 << 32


def begin_word(seq):
    """The odd in-progress marker stamped before slot ``seq``'s payload."""
    return (2 * int(seq) + 1) % _WORD_MOD


def commit_word(seq):
    """The even committed marker stamped after slot ``seq``'s payload."""
    return (2 * int(seq) + 2) % _WORD_MOD


def seq_word_offset(seq, slots, seq_base):
    """Byte offset of the seq word guarding ring slot ``seq % slots``,
    given the base of the seq-word array (``shm_ring_seq_base``)."""
    return int(seq_base) + (int(seq) % int(slots)) * SEQ_WORD_BYTES


def pack_word(word):
    """The 4-byte little-endian encoding of a seq word."""
    return _WORD.pack(int(word) % _WORD_MOD)


def unpack_word(data):
    """Decode a 4-byte seq word read from the region."""
    return _WORD.unpack(bytes(data)[:SEQ_WORD_BYTES])[0]


def slot_committed(word, seq):
    """Whether a seq word proves slot ``seq``'s payload is committed.

    False for the odd in-progress marker, for any earlier (or later —
    the ring lapped) sequence's word, and for zero (never written)."""
    return int(word) == commit_word(seq)


# -- torn-read accounting ----------------------------------------------------
#
# Readers live in client-side code with no server handle, so the count
# is a process-wide module counter (the port has no /metrics yet).

_lock = threading.Lock()
_torn = 0


def note_torn(count=1):
    """Record ``count`` torn/stale slot reads that fell back in-band."""
    global _torn
    with _lock:
        _torn += int(count)


def torn_total():
    """Process-wide torn/stale ring reads so far."""
    return _torn
