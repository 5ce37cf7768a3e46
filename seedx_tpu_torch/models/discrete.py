"""Discrete-tokenizer slot (identity placeholder; reference:
seedx_tpu/models/discrete.py).

Parity with the reference's ``DiscreteModleIdentity``
(reference: src/models/tokenizer/discrete_models.py:7-17 +
configs/discrete_model/discrete_identity.yaml): a hook in the tokenizer
slot for a future quantized visual tokenizer; the shipped model passes
features through unchanged.
"""

from __future__ import annotations


class DiscreteIdentity:
    """Identity: returns its input; ``encode_image_embeds`` mirrors the
    reference's forward contract."""

    def __call__(self, image_embeds):
        return image_embeds

    def encode_image_embeds(self, image_embeds):
        return image_embeds
