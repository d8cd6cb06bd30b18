"""Tensor ops of the serving and training paths; the two kernel wrappers
are fused_field.fused_field_eval and march_select.march_select."""
