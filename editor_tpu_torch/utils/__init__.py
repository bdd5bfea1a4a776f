"""utils of the editor_tpu_torch port."""
