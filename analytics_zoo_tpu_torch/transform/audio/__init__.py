"""Audio featurization and CTC decoding (counterpart of
``transform/audio``)."""

from analytics_zoo_tpu_torch.transform.audio.decoders import (
    ALPHABET,
    BLANK_ID,
    ASREvaluator,
    NGramDecoder,
    TranscriptVectorizer,
    VocabDecoder,
    beam_search_decode,
    best_path_decode,
    cer,
    evaluate_ctc_decoders,
    ids_to_text,
    levenshtein,
    wer,
)
from analytics_zoo_tpu_torch.transform.audio.featurize import (
    N_MELS,
    SAMPLE_RATE,
    WINDOW_SIZE,
    WINDOW_STRIDE,
    TimeSegmenter,
    dft_specgram,
    featurize,
    frame_signal,
    make_featurizer_device,
    mel_features,
    mel_filterbank_matrix,
    transpose_flip,
)
from analytics_zoo_tpu_torch.transform.audio.readers import (
    read_audio,
    read_flac,
    read_wav,
)

__all__ = [k for k in dir() if not k.startswith("_")]
