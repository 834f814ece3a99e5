"""Host scripts of the port: the RefSeq fetcher (``download_genomes``)."""
