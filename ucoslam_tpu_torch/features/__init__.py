"""Keypoint extraction (ORB, FREAK, SURF; AKAZE and BRISK through cv2), frame
ingestion and the vocabulary trainer."""
