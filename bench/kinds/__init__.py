"""One driver per kind of traffic mix; a mix's ``kind`` names its driver."""
