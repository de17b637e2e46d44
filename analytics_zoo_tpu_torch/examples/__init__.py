"""The port's command-line examples, each a module run with ``python -m``
(counterparts of the root ``examples/`` scripts, with their options,
defaults and choices, and ``--device``, ``cuda`` unless ``cpu`` is
asked for):

- ``generate_records``: a VOC devkit or an image folder → ``.azr``
  shards;
- ``train_ssd``: SSD training on records (host or device augmentation);
- ``test_ssd``: VOC mAP of a saved model on records;
- ``predict_ssd``: an image folder → a text file of detections an image,
  and drawn images with ``--vis``;
- ``train_shapes_e2e``: SSD300 trained from scratch on rendered shapes
  and scored by VOC07 mAP.

Each has ``main(argv=None)``; ``common`` holds what they share.
"""
