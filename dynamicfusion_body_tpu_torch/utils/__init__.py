"""Port of dynamicfusion_body_tpu/utils."""
