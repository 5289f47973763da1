"""Row padding for fixed-shape batches."""
