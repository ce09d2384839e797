"""MinAtar games (Young & Tian, arXiv 1903.03176), batched."""
