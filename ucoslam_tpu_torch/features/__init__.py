"""ORB feature extraction and frame ingestion."""
