"""Share of the vision buckets' slots that carried a frame, over the
window: slot-steps over steps × slots (``VisionTaskBucket`` counters)."""


def read(run):
    c = run.counters
    if not c.get("bucket_steps"):
        return None
    return 100.0 * c["bucket_slot_steps"] / (c["bucket_steps"]
                                             * c["bucket_slots"])
