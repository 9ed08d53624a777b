"""Testing helpers of the port: deterministic fault injection (:mod:`.chaos`)."""
