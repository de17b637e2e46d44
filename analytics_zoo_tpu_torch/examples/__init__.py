"""The port's command-line examples, each a module run with ``python -m``
(counterparts of the root ``examples/`` scripts, with their options,
defaults and choices, and ``--device``, ``cuda`` unless ``cpu`` is
asked for; the three DS2 ones add ``--rnn-engine``):

- ``generate_records``: a VOC devkit or an image folder → ``.azr``
  shards;
- ``train_ssd``: SSD training on records (host or device augmentation);
- ``test_ssd``: VOC mAP of a saved model on records;
- ``predict_ssd``: an image folder → a text file of detections an image,
  and drawn images with ``--vis``;
- ``train_shapes_e2e``: SSD300 trained from scratch on rendered shapes
  and scored by VOC07 mAP;
- ``train_ds2``: DeepSpeech2 CTC training on the synthetic tone task or
  a ``mapping.txt`` folder, with held-out greedy and beam CER;
- ``ds2_inference``: wavs → transcripts, or a mapping file → WER/CER,
  through ``DeepSpeech2Pipeline``;
- ``long_audio_asr``: the chunked pipeline against one sequence-parallel
  forward over the ranks;
- ``train_attention_asr``: AttentionASR full, ring (over the ranks) or
  MoE, with held-out CER;
- ``predict_frcnn``: Faster-RCNN over a JPEG folder or a demo batch;
- ``train_frcnn_shapes``: Faster-RCNN from scratch on rendered shapes →
  VOC07 mAP;
- ``fraud_detection``: the bagged fraud MLP → AUPRC;
- ``recommender``: NCF or Wide&Deep → held-out MAE;
- ``sentiment``: SentimentNet's heads → held-out accuracy;
- ``image_augmentation``: the vision ops on one JPEG → nine JPEGs.

Each has ``main(argv=None)``; ``common`` holds what they share.
"""
