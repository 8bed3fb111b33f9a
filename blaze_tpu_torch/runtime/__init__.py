"""Runtime: executor, prefetch pipeline, launch/transfer accounting."""
