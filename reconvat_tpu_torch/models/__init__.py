"""Model families (ReconVAT) and the shared signal-chain helpers."""
