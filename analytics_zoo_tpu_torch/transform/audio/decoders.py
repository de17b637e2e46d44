"""CTC decoders and ASR metrics (counterpart of
``transform/audio/decoders.py``, numpy on the host): greedy best-path,
prefix beam search, the vocabulary snap by edit distance, the bigram
rerank, the transcript vectorizer for CTC labels, WER/CER, and the
shared evaluation of the greedy and beam decoders.

Alphabet: 29 chars, blank at index 0 (reference ``InferenceExample.scala:
17-23``): ``_'A-Z<space>``.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

ALPHABET = "_'ABCDEFGHIJKLMNOPQRSTUVWXYZ "
BLANK_ID = 0


def ids_to_text(ids, alphabet: str = ALPHABET,
                blank_id: int = BLANK_ID) -> str:
    """CTC collapse: repeat-merge + blank-strip over per-frame argmax ids.

    Split out of :func:`best_path_decode` so the argmax can run ON DEVICE
    (the fused ASR serving path reads back (T,) int ids — ~30× fewer
    bytes than the full (T, C) log-probs)."""
    out: List[str] = []
    prev = -1
    for i in np.asarray(ids):
        if i != prev and i != blank_id:
            out.append(alphabet[int(i)])
        prev = i
    return "".join(out)


def best_path_decode(log_probs: np.ndarray, alphabet: str = ALPHABET,
                     blank_id: int = BLANK_ID) -> str:
    """Greedy CTC: per-frame argmax → collapse repeats → strip blanks
    (reference ``BestPathDecoder``)."""
    return ids_to_text(np.asarray(log_probs).argmax(axis=-1),
                       alphabet, blank_id)


def beam_search_decode(log_probs: np.ndarray, beam_width: int = 16,
                       alphabet: str = ALPHABET, blank_id: int = BLANK_ID,
                       prune_log_prob: float = -18.0) -> str:
    """CTC prefix beam search (Hannun et al. 2014) — sums probability over
    ALL alignments of each prefix instead of following one per-frame
    argmax path, so it recovers transcripts greedy decoding loses when
    probability mass is split across alignments.  Net-new over the
    reference's decoder stack (greedy / vocab-snap / bigram rerank).

    Per prefix two scores are tracked in log space: ``p_b`` (alignments
    ending in blank) and ``p_nb`` (ending in the prefix's last char).
    ``prune_log_prob`` skips symbols below the threshold per frame (beam
    quality is insensitive; cost drops ~|A|-fold).  Exact for
    ``beam_width`` ≥ the number of reachable prefixes (the oracle bound
    the tests use).
    """
    lp = np.asarray(log_probs, np.float32)
    NEG = -np.inf
    lse = np.logaddexp                     # handles -inf operands exactly

    # beams: {prefix tuple: (p_blank, p_nonblank)}
    beams = {(): (0.0, NEG)}
    for t in range(lp.shape[0]):
        frame = lp[t]
        blank_lp = float(frame[blank_id])
        kept = [(s, float(frame[s]))
                for s in np.flatnonzero(frame >= prune_log_prob)
                if s != blank_id]
        nxt: dict = {}

        def add(prefix, pb, pnb):
            opb, opnb = nxt.get(prefix, (NEG, NEG))
            nxt[prefix] = (lse(opb, pb), lse(opnb, pnb))

        for prefix, (p_b, p_nb) in beams.items():
            p_tot = lse(p_b, p_nb)
            # blank extends both paths, prefix unchanged
            add(prefix, p_tot + blank_lp, NEG)
            for s, p_s in kept:
                if prefix and prefix[-1] == s:
                    # repeat char: only a blank-separated path extends the
                    # prefix; the non-blank path merges into the SAME prefix
                    add(prefix + (s,), NEG, p_b + p_s)
                    add(prefix, NEG, p_nb + p_s)
                else:
                    add(prefix + (s,), NEG, p_tot + p_s)
        beams = dict(sorted(
            nxt.items(),
            key=lambda kv: -lse(*kv[1]))[:beam_width])

    best = max(beams.items(), key=lambda kv: lse(*kv[1]))[0]
    return "".join(alphabet[s] for s in best)


def levenshtein(a: Sequence, b: Sequence) -> int:
    """Edit distance (reference ``ASREvaluator`` distance kernel)."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def wer(reference: str, hypothesis: str) -> float:
    """Word error rate (reference ``ASREvaluator.scala:41``)."""
    ref_words = reference.split()
    if not ref_words:
        return 0.0 if not hypothesis.split() else 1.0
    return levenshtein(ref_words, hypothesis.split()) / len(ref_words)


def cer(reference: str, hypothesis: str) -> float:
    """Character error rate."""
    if not reference:
        return 0.0 if not hypothesis else 1.0
    return levenshtein(reference, hypothesis) / len(reference)


class VocabDecoder:
    """Snap each decoded word to the nearest vocabulary word by edit
    distance (reference ``VocabDecoder.scala:37``); words already in vocab
    pass through."""

    def __init__(self, vocab: Sequence[str], max_distance: int = 2):
        self.vocab = [v.upper() for v in vocab]
        self.vocab_set = set(self.vocab)
        self.max_distance = max_distance

    def decode_word(self, word: str) -> str:
        if not word or word in self.vocab_set:
            return word
        best, best_d = word, self.max_distance + 1
        for v in self.vocab:
            d = levenshtein(word, v)
            if d < best_d:
                best, best_d = v, d
        return best if best_d <= self.max_distance else word

    def __call__(self, text: str) -> str:
        return " ".join(self.decode_word(w) for w in text.split())


class NGramDecoder:
    """Bigram-context candidate rerank (reference ``NGramDecoder.scala:36``):
    among near-vocab candidates for each word, prefer the one whose bigram
    with the previous decoded word was seen in the corpus."""

    def __init__(self, vocab: Sequence[str], bigrams: Sequence[Sequence[str]],
                 max_distance: int = 2):
        self.inner = VocabDecoder(vocab, max_distance)
        self.bigrams = {(a.upper(), b.upper()) for a, b in bigrams}
        self.max_distance = max_distance

    def _candidates(self, word: str):
        """(candidate, distance) pairs within max_distance, from one scan
        of the vocabulary (the word itself at distance 0 when none)."""
        cands = [(v, levenshtein(word, v)) for v in self.inner.vocab]
        cands = [(v, d) for v, d in cands if d <= self.max_distance]
        return cands or [(word, 0)]

    def __call__(self, text: str) -> str:
        out: List[str] = []
        for w in text.split():
            cands = self._candidates(w)
            pick = None
            if out:
                for c, _ in cands:
                    if (out[-1], c) in self.bigrams:
                        pick = c
                        break
            if pick is None:
                pick = min(cands, key=lambda cd: cd[1])[0]
            out.append(pick)
        return " ".join(out)


class TranscriptVectorizer:
    """transcript → padded label-id vector for CTC training (reference
    ``acoustic/TranscriptVectorizer.scala:11``)."""

    def __init__(self, alphabet: str = ALPHABET, max_length: int = 200):
        self.alphabet = alphabet
        self.index = {c: i for i, c in enumerate(alphabet)}
        self.max_length = max_length

    def __call__(self, transcript: str):
        """Returns (ids (max_length,) int32, mask (max_length,) float32)."""
        ids = [self.index[c] for c in transcript.upper() if c in self.index]
        ids = ids[: self.max_length]
        out = np.zeros(self.max_length, np.int32)
        mask = np.zeros(self.max_length, np.float32)
        out[: len(ids)] = ids
        mask[: len(ids)] = 1.0
        return out, mask


class ASREvaluator:
    """Accumulating WER/CER over utterances (reference ``ASREvaluator``)."""

    def __init__(self):
        self.word_errors = 0
        self.words = 0
        self.char_errors = 0
        self.chars = 0

    def add(self, reference: str, hypothesis: str) -> None:
        self.word_errors += levenshtein(reference.split(), hypothesis.split())
        self.words += len(reference.split())
        self.char_errors += levenshtein(reference, hypothesis)
        self.chars += len(reference)

    @property
    def wer(self) -> float:
        return self.word_errors / max(self.words, 1)

    @property
    def cer(self) -> float:
        return self.char_errors / max(self.chars, 1)


def evaluate_ctc_decoders(forward_fn, batches,
                          alphabet: str = ALPHABET) -> dict:
    """Held-out CER and exact-sequence accuracy with both the greedy and
    the prefix-beam decoder.

    ``forward_fn(inputs) → (B, T, n_alphabet)`` log-probs (a tensor on
    any device, or an array); ``batches`` yield ``{"input", "labels"}``
    with 0 = padding in labels."""
    stats = {"greedy": [0, 0], "beam": [0, 0]}    # [edit distance, exact]
    total_len = n_seq = 0
    for hb in batches:
        log_probs = forward_fn(hb["input"])
        if hasattr(log_probs, "detach"):
            log_probs = log_probs.detach().cpu().numpy()
        for i in range(hb["input"].shape[0]):
            ref = "".join(alphabet[t] for t in hb["labels"][i] if t > 0)
            lp = np.asarray(log_probs[i])
            for name, hyp in (("greedy", best_path_decode(lp, alphabet)),
                              ("beam", beam_search_decode(lp,
                                                          alphabet=alphabet))):
                stats[name][0] += levenshtein(hyp, ref)
                stats[name][1] += int(hyp == ref)
            total_len += max(len(ref), 1)
            n_seq += 1
    g, b = stats["greedy"], stats["beam"]
    return {
        "cer": round(g[0] / max(total_len, 1), 4),
        "exact_sequence_acc": round(g[1] / max(n_seq, 1), 4),
        "beam_cer": round(b[0] / max(total_len, 1), 4),
        "beam_exact_sequence_acc": round(b[1] / max(n_seq, 1), 4),
        "sequences": n_seq,
    }
