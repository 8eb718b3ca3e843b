"""The port's caches: the text-embedding cache (``text_embeds``)."""
