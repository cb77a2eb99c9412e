from .corpus import BOS_OFFSET, WalkCorpus, skipgram_pairs

__all__ = ["BOS_OFFSET", "WalkCorpus", "skipgram_pairs"]
