# device-resident eigensolver engines
