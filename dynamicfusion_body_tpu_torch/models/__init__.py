"""Port of dynamicfusion_body_tpu/models."""
