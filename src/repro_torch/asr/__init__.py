"""ASR pieces of the port: SpecAugment and the transducer loss."""
